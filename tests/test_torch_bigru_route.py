"""The CBHG's route for its bidirectional GRU (``models/modules.py``), on
the CPU at small widths:

- where no gradient is needed (``torch.inference_mode``, as synthesis runs,
  or ``torch.no_grad``, as the train loop's evaluation) and the carry is
  float32, the CBHG calls ``ops/kernels/gru.py::bigru_from_params`` once
  (K4 on the card, its plain scan here) and not the ``BiGRU`` module: with
  lengths and an initial state (the encoder under Deep Voice 2), with
  lengths alone (the encoder), without lengths (the post-net).  What it
  computes there is held to the JAX package's CBHG by
  ``tests/test_torch_modules.py::test_cbhg``;
- with gradients on it never calls it, runs the module's scan, and its
  gradients are bit for bit those of a CBHG whose route is taken away;
- a bfloat16 carry keeps the module's scan, bit for bit;
- the synthesizer counts the K4 sequences a captured chunk holds
  (``synth.replay``'s ``k4``) and the chunks whose decode ran K4
  (``chunks_k4``, replayed or eager), here with the CPU scan standing in
  for the kernel's launch counter.
"""

import pytest
import torch

from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.models import modules as tm
from tacotron_tpu_torch.ops.kernels import gru as tgru
from tacotron_tpu_torch.synth import synthesizer as tsynth
from tacotron_tpu_torch.utils import trace
from test_torch_prewarm import AUDIO, MODEL, TEXTS

CASES = {
    # name: (rnn size, lengths, initial state); the highway's dim fix is on
    # where the rnn size differs from the input width (10)
    "lengths+state": (8, [11, 6, 9], True),
    "lengths": (8, [11, 4, 11], False),
    "no_lengths": (10, None, False),
}

NO_GRAD = {"inference_mode": torch.inference_mode,
           "no_grad": torch.no_grad}


def _inputs(case: str, dtype=torch.float32):
    """(CBHG in eval mode with seeded weights, x [3, 11, 10], lengths,
    initial state [3, 2H] or None)."""
    rnn_size, lengths, with_state = CASES[case]
    gen = torch.Generator().manual_seed(7)
    mod = tm.CBHG(10, 4, 6, 2, 2, rnn_size, (12, 10), 3).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3, generator=gen)
    x = torch.randn((3, 11, 10), generator=gen).to(dtype)
    state = torch.randn((3, 2 * rnn_size), generator=gen).to(dtype)
    lens = None if lengths is None else torch.tensor(lengths)
    return mod, x, lens, state if with_state else None


@pytest.fixture
def spy(monkeypatch):
    """The calls of ``bigru_from_params`` from the CBHG, and of the
    ``BiGRU`` module's own forward."""
    calls = {"route": 0, "module": 0}
    real = tm.bigru_from_params

    def counted(*args, **kwargs):
        calls["route"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tm, "bigru_from_params", counted)
    real_forward = tm.BiGRU.forward

    def module_forward(self, *args, **kwargs):
        calls["module"] += 1
        return real_forward(self, *args, **kwargs)

    monkeypatch.setattr(tm.BiGRU, "forward", module_forward)
    return calls


@pytest.mark.parametrize("mode", list(NO_GRAD))
@pytest.mark.parametrize("case", list(CASES))
def test_inference_takes_the_kernel_route(spy, case, mode):
    mod, x, lens, state = _inputs(case)
    with NO_GRAD[mode]():
        got = mod(x, lens, rnn_init_state=state)
    assert spy == {"route": 1, "module": 0}
    assert got.dtype == torch.float32
    assert got.shape == (3, 11, 2 * CASES[case][0])
    if lens is not None:
        # nothing past each row's end, as the scan
        t = torch.arange(x.shape[1])[None, :, None]
        assert not got.masked_select(t >= lens[:, None, None]).any()


@pytest.mark.parametrize("case", list(CASES))
def test_training_keeps_the_scan(spy, monkeypatch, case):
    mod, x, lens, state = _inputs(case)
    x = x.requires_grad_()

    def grads():
        mod.zero_grad()
        x.grad = None
        out = mod(x, lens, rnn_init_state=state)
        (out ** 2).sum().backward()
        return [x.grad.clone()] + [p.grad.clone() for p in mod.parameters()]

    got = grads()
    assert spy == {"route": 0, "module": 1}

    def no_route(*args, **kwargs):
        raise AssertionError("the route ran with gradients on")

    monkeypatch.setattr(tm, "bigru_from_params", no_route)
    want = grads()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_carry_keeps_the_scan(spy, case):
    mod, x, lens, state = _inputs(case, torch.bfloat16)
    with torch.inference_mode():
        got = mod(x, lens, rnn_init_state=state)
    assert spy == {"route": 0, "module": 1}
    assert got.dtype == torch.bfloat16
    want = mod(x, lens, rnn_init_state=state)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


@pytest.fixture
def counted_scan(monkeypatch):
    """The CPU scan counted as a kernel launch, so the synthesizer's K4
    bookkeeping can be read here."""
    real = tgru.gru_reference_scan

    def scan(*args):
        tgru.gru_sequence.launches += 1
        return real(*args)

    monkeypatch.setattr(tgru, "gru_reference_scan", scan)
    monkeypatch.setattr(tgru.gru_sequence, "launches", 0)


@pytest.mark.parametrize("counted", [True, False], ids=["counted", "cpu"])
def test_synthesize_counts_k4_chunks(monkeypatch, request, counted):
    if counted:
        request.getfixturevalue("counted_scan")
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    cfg = TorchConfig.from_dict({"audio": AUDIO, "model": MODEL})
    ts = tsynth.Synthesizer(device="cpu").init_random(cfg, seed=2)
    kw = dict(speaker_ids=[0, 1, 1], max_steps=4, librosa_trim=False,
              collect_timings=True)
    ts.prewarm(**ts.prewarm_args(TEXTS, max_steps=4))
    (graphed,) = ts._graphs.values()
    # the encoder's and the post-net's BiGRU, two directions each
    k4 = 4 if counted else 0
    assert graphed.launches == {"k4": k4}
    replayed = ts.synthesize(TEXTS, **kw)["timings"]
    eager = ts.synthesize(TEXTS[:1], **kw)["timings"]   # a capture miss
    (replay,) = rec.records("synth.replay")
    assert replay.attrs["k4"] == k4
    for t, replays in ((replayed, 1), (eager, 0)):
        assert (t["chunks"], t["chunks_replayed"]) == (1, replays)
        assert t["chunks_k4"] == (1 if counted else 0)
