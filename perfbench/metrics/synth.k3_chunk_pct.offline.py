"""Share of the chunks of the window's calls outside the traced part whose
vocoder ran the spectral-step engine, K3 + K2 (``collect_timings``'
``chunks_k3`` over ``chunks``).  A program that does not report
``chunks_k3`` gives nothing."""


def read(run):
    units = [u for u in run.units if "chunks_k3" in u and not u["traced"]]
    chunks = sum(u["chunks"] for u in units)
    if not chunks:
        return None
    return 100.0 * sum(u["chunks_k3"] for u in units) / chunks
