"""Share of the chunks of the window's calls outside the traced part whose
decode ran its BiGRUs through the GRU kernel, K4 (``collect_timings``'
``chunks_k4`` over ``chunks``).  A program that does not report
``chunks_k4`` gives nothing."""


def read(run):
    units = [u for u in run.units if "chunks_k4" in u and not u["traced"]]
    chunks = sum(u["chunks"] for u in units)
    if not chunks:
        return None
    return 100.0 * sum(u["chunks_k4"] for u in units) / chunks
