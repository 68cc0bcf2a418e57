"""The port's feeders against the JAX package's on the corpus that
``tests/test_data.py::_make_corpus`` + ``build_from_path`` writes.

- ``DataFeeder``: the same seed gives exactly the JAX feeder's batches, in
  order (ten train batches), its static test batch and its
  ``bucket_shapes``: with spectrogram and with waveform targets, after a
  resume inside the greedy initial phase, and with corpus-max padding.
- ``ResidentDataFeeder`` gives the port's streaming feeder's batches, the
  big tensors gathered from the store by ``assemble``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tacotron_tpu.data import DataFeeder, build_from_path
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.data import DataFeeder as PortFeeder
from tacotron_tpu_torch.data.resident import ResidentDataFeeder
from test_data import _make_corpus, _tiny_config


def _port_config(cfg):
    return TorchConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two speakers, waveforms stored beside the spectrograms."""
    root = tmp_path_factory.mktemp("port_corpus")
    base = _tiny_config()
    cfg = base.replace(data=dataclasses.replace(base.data,
                                                store_waveform=True))
    dirs = []
    for spk in range(2):
        meta = _make_corpus(str(root / f"spk{spk}"), seed=spk)
        build_from_path(meta, cfg, num_workers=1)
        dirs.append(str(root / f"spk{spk}" / "data"))
    return dirs


def _assert_batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "Batch"
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        g = np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


CASES = {
    "spectrograms": dict(),
    "waveforms": dict(on_device_features=True),
    "greedy-resume": dict(initial_phase_step=8, main_data_greedy_factor=1.0,
                          main_data=("spk1",), start_step=3),
    "corpus-max": dict(pad_to_corpus_max=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_feeder_matches_jax(corpus, case):
    kw = dict(CASES[case])
    start_step = kw.pop("start_step", 0)
    base = _tiny_config()
    data_kw = {k: kw.pop(k) for k in list(kw) if k == "pad_to_corpus_max"}
    cfg = base.replace(train=dataclasses.replace(base.train, **kw),
                       data=dataclasses.replace(base.data, **data_kw))
    jax_train = DataFeeder(corpus, cfg, data_type="train", seed=11,
                           start_step=start_step)
    port_train = PortFeeder(corpus, _port_config(cfg), data_type="train",
                            seed=11, start_step=start_step)
    assert port_train.bucket_shapes() == jax_train.bucket_shapes()
    jb, pb = jax_train.batches(), port_train.batches()
    for _ in range(10):
        _assert_batches_equal(next(pb), next(jb))
    jax_test = DataFeeder(corpus, cfg, data_type="test", seed=11)
    port_test = PortFeeder(corpus, _port_config(cfg), data_type="test",
                           seed=11)
    _assert_batches_equal(next(port_test.batches()),
                          next(jax_test.batches()))


@pytest.mark.parametrize("waveforms", [False, True],
                         ids=["spectrograms", "waveforms"])
def test_resident_feeder_matches_host(corpus, waveforms):
    base = _port_config(_tiny_config())
    cfg = base.replace(train=dataclasses.replace(
        base.train, on_device_features=waveforms))
    host_cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, pad_to_corpus_max=True))
    host = PortFeeder(corpus, host_cfg, data_type="train", seed=5)
    res = ResidentDataFeeder(corpus, cfg, data_type="train", seed=5)
    store = res.upload("cpu")
    hb, rb = host.batches(), res.batches()
    for _ in range(6):
        want = next(hb)
        small, idx = next(rb)
        got = res.assemble(
            store, small._replace(**{k: torch.as_tensor(getattr(small, k))
                                     for k in ("inputs", "input_lengths")}),
            torch.from_numpy(idx))
        _assert_batches_equal(got, want)
