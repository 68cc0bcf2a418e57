"""Mean host time a step of the window waits for its batch from the
prefetcher (``DevicePrefetcher.get``), over the steps outside the traced
part."""


def read(run):
    waits = [u["wait_ms"] for u in run.units if not u["traced"]]
    return sum(waits) / len(waits) if waits else None
