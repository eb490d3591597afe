"""``read_wait_ms_per_round`` (engine, ``engine/trainer.py``): the host
milliseconds inside the program's ``span.engine.read`` labels (each read
of a device value by the fit's loop: an epoch's metrics, the mean
trace), over the profiled job's ``span.engine.round`` labels.  Nothing
where the program has no such labels.  A round is a ``span.engine.round``
label, which only the fit's rounds carry: in a cell that refines, the
refinement's count without its rounds."""


def read(run):
    if run.profile is None:
        return None
    labels = run.profile.labels
    rounds = sum(1 for n, _, _ in labels if n == "span.engine.round")
    reads = [e - s for n, s, e in labels if n == "span.engine.read"]
    if not rounds or not reads:
        return None
    return 1e-3 * sum(reads) / rounds
