"""The whole step's share of the card's float32 peak (TF32 is off): the
matrix-product FLOPs of each step's padded shape (forward and twice it
backward; ``flops.py``) over the steps' wall time, outside the traced
part."""

from perfbench import flops


def read(run):
    units = [u for u in run.units if not u["traced"]]
    wall = sum(u["wall_s"] for u in units)
    if not units or wall <= 0.0:
        return None
    m = run.config["config"]["model"]
    batch = run.config["config"]["train"]["batch_size"]
    work = sum(flops.train_step_flops(m, batch, u["t_in"], u["t_out"])
               for u in units)
    return 100.0 * work / wall / flops.PEAK_F32_FLOPS
