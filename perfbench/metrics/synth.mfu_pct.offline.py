"""The whole call's share of the card's peak: the least time of a call's
work (the model family's forward matrix products at the float32 peak, the
Griffin-Lim products at the bf16 peak; ``drivers/offline.py``) over the
mean wall time of the window's calls outside the traced part."""

from perfbench import core
from perfbench.drivers.offline import least_call_seconds, per_unit_mean


def read(run):
    units = [u for u in run.units if not u["traced"]]
    if not units:
        return None
    family = core.family(run.config)
    least = sum(least_call_seconds(family, run.config["config"], run.traffic,
                                   u) for u in units) / len(units)
    return 100.0 * least / per_unit_mean(run.units, "wall_s")
