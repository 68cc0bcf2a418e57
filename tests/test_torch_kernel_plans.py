"""The launch plans of two CUDA kernels of the PyTorch port, on the CPU:
``cluster_plan`` (how the fused GRU, ``csrc/gru.cu``, splits the recurrence
over a thread-block cluster, or streams it) and ``ola_plan`` (the vector
width and tile of the overlap-add, ``csrc/ola.cu``).  The wrappers launch
the kernels with exactly these plans, so these tests guard what the kernels
are given; the kernels themselves run only on the card (``chip_smoke.py``).
"""

import pytest

from tacotron_tpu_torch.config import AudioConfig
from tacotron_tpu_torch.ops.kernels import gru, ola

HS = [5, 8, 37, 40, 128, 256, 384, 600, 1024]
NS = [1, 4, 17]


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("H", HS)
def test_cluster_plan_covers_every_unit_and_row(H, N):
    plan = gru.cluster_plan(N, H)
    assert plan.route in ("cluster", "streaming")
    # every unit is owned by exactly one block of a cluster, and every
    # block owns one at least
    assert (plan.cluster - 1) * plan.hs < H
    owners = [0] * H
    for k in range(plan.cluster):
        for unit in range(k * plan.hs, min(H, (k + 1) * plan.hs)):
            owners[unit] += 1
    assert owners == [1] * H
    assert 1 <= plan.cluster <= gru.CLUSTER_MAX_BLOCKS
    # the rows: R per cluster (or per streaming block); the G = ceil(N / R)
    # groups the kernel launches cover N
    assert 1 <= plan.rows <= gru.CLUSTER_ROWS
    groups = -(-N // plan.rows)
    assert plan.rows * groups >= N
    assert groups <= N
    # the shared memory a block is launched with fits the H100's 227 KB
    assert plan.smem_bytes <= 227 * 1024
    if plan.route == "cluster":
        assert plan.smem_bytes >= gru.cluster_layout_bytes(H, plan.cluster)
        # no two blocks of a cluster share an SM (228 KB each)
        assert 2 * (plan.smem_bytes + 1024) > 228 * 1024
        # four columns per float4: at most two candidate quads per warp
        assert -(-plan.hs // 4) <= 16
    else:
        assert (plan.cluster, plan.hs, plan.rows) == (1, H, 1)
        assert plan.smem_bytes == gru.streaming_bytes(H)


@pytest.mark.parametrize("H", HS)
def test_cluster_plan_route_flips_where_the_slices_stop_fitting(H):
    """The cluster route exactly where a block's weight columns, state and
    gates fit its shared memory at the chosen cluster size; the streaming
    route above.  The serving widths (128 and 256) are on the cluster
    route, with 8 and 16 blocks of 16 units."""
    plan = gru.cluster_plan(4, H)
    blocks = min(16, max(1, -(-H // 16)))
    fits = gru.cluster_layout_bytes(H, blocks) <= 227 * 1024
    assert (plan.route == "cluster") == fits
    if H in (128, 256):
        assert (plan.route, plan.cluster, plan.hs, plan.rows) == \
            ("cluster", H // 16, 16, 4)


def test_cluster_plan_boundary_is_monotone():
    """One boundary only: H = 512 is the widest state on the cluster route
    and everything wider streams."""
    routes = [gru.cluster_plan(4, H).route for H in range(1, 1100)]
    last = routes.index("streaming")
    assert last == 512                      # H = 513
    assert set(routes[:last]) == {"cluster"}
    assert set(routes[last:]) == {"streaming"}


@pytest.mark.parametrize("n_fft,hop,num_samples,vec", [
    (2048, 300, 799 * 300, 4),     # the reference geometry
    (256, 128, 20 * 128, 4),       # the small geometry
    (254, 128, 20 * 128, 1),       # n_fft / 2 = 127 is odd
    (256, 125, 20 * 125, 1),       # a hop that is not a multiple of 2
    (256, 126, 20 * 126, 2),       # a hop that is a multiple of 2 only
    (2048, 300, 2397, 1),          # an output length not a multiple of 2
    (2048, 300, 2398, 2),
    (2048, 300, 1024, 4),          # one frame: half of n_fft
])
def test_ola_plan_vector_width(n_fft, hop, num_samples, vec):
    plan = ola.ola_plan(n_fft, hop, num_samples)
    assert plan.vec == vec
    assert plan.tile == ola.OLA_TILE
    if plan.vec > 1:
        assert hop % plan.vec == 0 and (n_fft // 2) % plan.vec == 0
        assert n_fft % plan.vec == 0 and num_samples % plan.vec == 0


@pytest.mark.parametrize("cfg", [
    AudioConfig(),
    AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                frame_length_ms=16),
    AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=7.8125,
                frame_length_ms=16)])
def test_ola_plan_groups_stay_in_one_hop_block(cfg):
    """With the plan's width every group of samples lies in one hop block
    and wholly inside or outside the centered output, the condition the
    kernel's per-group predicates rely on."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    T = 9
    num_samples = (T - 1) * hop
    vec = ola.ola_plan(n_fft, hop, num_samples).vec
    half = n_fft // 2
    for p0 in range(0, n_fft + hop * (T - 1), vec):
        p1 = p0 + vec - 1
        assert p0 // hop == p1 // hop
        inside = [0 <= p - half < num_samples for p in (p0, p1)]
        assert inside[0] == inside[1]
