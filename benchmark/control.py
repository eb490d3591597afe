"""The readings that the check's limits are set from, on the card.

    python3 benchmark/control.py --workload wb_demix --seeds 1 2 3 \
        --control-seeds 1 2 3 > readings.jsonl

For each of ``--seeds``: the recording and one whole job of the program
(``fit``, then ``refine`` where the traffic has it), as a run makes them
(``harness.fit_source``: a stored configuration's recording written to
its file and streamed from it), and the check's numbers for it (the
lower readings: sound runs).  For each of ``--control-seeds``: the plain
reference, its refinement included, computed with TF32-rounded products
in the program's place, against the float32 reference (the upper
readings: the control, which has to come out not correct).  One JSON
line per reading; the benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()

    import torch

    torch.set_num_threads(2)
    from cardbench import check, harness, spec

    cell = spec.cell(args.workload)
    dev = torch.device("cuda")
    gamma = cell["traffic_spec"]["optimizer"]["gamma_motion"]

    def emit(kind, seed, readings, seconds):
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "seconds": seconds, **readings}
        print(json.dumps(line), flush=True)

    for seed in args.seeds:
        from dnmf_tpu_torch.engine.trainer import DeformableNMF
        from dnmf_tpu_torch.models import graphs

        t0 = time.perf_counter()
        model, opt, runtime = harness.engine_configs(cell, seed)
        with harness.fit_source(cell, seed, dev) as (rec, source):
            eng = DeformableNMF(model, opt, runtime, positions=rec.pos,
                                device=dev, beta0=rec.beta0)
            job = harness.run_job(eng, source,
                                  cell["traffic_spec"].get("refine"), dev)
            del eng
            graphs.clear()
            torch.cuda.empty_cache()
            reference = check.Reference(cell, rec, seed,
                                        check.audit_frames(job.metrics))
            readings = check.numbers(check.job_view(job, reference.frames,
                                                    gamma), reference)
            emit("program", seed, readings, time.perf_counter() - t0)
            del rec, source, reference, job
        gc.collect()
        torch.cuda.empty_cache()

    for seed in args.control_seeds:
        t0 = time.perf_counter()
        with harness.fit_source(cell, seed, dev) as (rec, _):
            t = int(cell["config_spec"]["num_frames"])
            frames = check.check_frames(cell["limits"], t, seed, [])
            reference = check.Reference(cell, rec, seed, [frames[0]])
            control = check.Reference(cell, rec, seed, [frames[0]],
                                      precision="tf32")
            emit("control_tf32", seed,
                 check.numbers(control.view(), reference),
                 time.perf_counter() - t0)
            del rec, reference, control
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
