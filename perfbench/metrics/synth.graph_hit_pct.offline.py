"""Share of the chunks of the window's calls outside the traced part that
replayed a captured program (``collect_timings``' ``chunks_replayed`` over
``chunks``; the others ran eagerly, a capture miss)."""


def read(run):
    units = [u for u in run.units if "chunks" in u and not u["traced"]]
    chunks = sum(u["chunks"] for u in units)
    if not chunks:
        return None
    return 100.0 * sum(u["chunks_replayed"] for u in units) / chunks
