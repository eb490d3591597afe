"""``host_reads_per_round`` (engine, ``engine/trainer.py``): the profiled
job's ``span.engine.read`` labels (one per read site's call: an epoch's
metrics, a round's mean trace) over its ``span.engine.round``
labels.  Nothing where the program has no such labels.  A round is a
``span.engine.round`` label, which only the fit's rounds carry: in a
cell that refines, the refinement's count without its rounds."""


def read(run):
    if run.profile is None:
        return None
    labels = run.profile.labels
    rounds = sum(1 for n, _, _ in labels if n == "span.engine.round")
    reads = sum(1 for n, _, _ in labels if n == "span.engine.read")
    if not rounds or not reads:
        return None
    return reads / rounds
