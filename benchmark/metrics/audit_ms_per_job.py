"""``audit_ms_per_job`` (engine, ``engine/trainer.py``): the host
milliseconds of the program's ``span.engine.audit`` labels (the
closed-form Grams' trust audit, its eager exact Gram and reads) over the
profiled job's ``span.engine.fit`` labels.  Nothing where the program has
no such labels."""


def read(run):
    if run.profile is None:
        return None
    labels = run.profile.labels
    fits = sum(1 for n, _, _ in labels if n == "span.engine.fit")
    audits = [e - s for n, s, e in labels if n == "span.engine.audit"]
    if not fits or not audits:
        return None
    return 1e-3 * sum(audits) / fits
