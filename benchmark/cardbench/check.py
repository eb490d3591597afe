"""Whether the timed jobs computed the fit: each job's outputs against the
plain reference (``references/<reference>.py``) on the same recording.

After the window the reference runs the job's schedule on a set of frames
drawn from the seed (``check_frames`` of the cell's limits: a count, or
``"all"``), with every job's audit frame added, from the same starting
warps and the traces that the fit's seed gives.  Frames are independent
in the fit, so each job's final warps and traces of those frames are
compared with the reference's one by one, and the losses the job logged
with the reference's losses: every epoch's where all frames are followed,
else the first epoch's, computed over all frames.  The reference reads
the frames from the recording (``rows`` and ``frames``): from the card,
or, for a stored recording, from its file, the bytes the fit streamed.
Where the traffic has ``refine``, the reference then follows the
refinement on the same frames (``follow_refine``), from its own fit's
warps and traces, and the job's positions and final traces are compared
with its.

The numbers, each with its limit (``limits/<workload>.json``):

* ``loss_err``: the largest relative gap between a logged epoch loss
  (``recon_mse + gamma_motion * reg``, a mean over all frames) and the
  reference's;
* ``beta_err``: per frame, the norm of the difference of the warps'
  changes (final minus start) over the norm of the reference's change,
  the largest over frames;
* ``c_err``: per frame, the norm of the traces' difference over the norm
  of the reference's traces, the largest over frames (the job's final
  traces: after the refinement, where there is one);
* ``audit_gap``: the gap between the audit's logged ``rel_err`` (closed-form
  against exact Gram at the frame of the strongest warp) and the
  reference's at the same frame;
* ``pos_err`` (refinement only): per frame, the norm of the difference of
  the positions' moves off the anchors over the norm of the reference's
  move, the largest over frames.

``beta_err`` is read after the fit: the refinement keeps the warps.  A
cell is held to the numbers its limits file lists; a missing or
non-finite reading counts as infinitely far off.
"""

from __future__ import annotations

import math
from typing import List

import torch

from cardbench import spec

NUMBERS = ("loss_err", "beta_err", "c_err", "audit_gap", "pos_err")


def schedule(traffic: dict) -> dict:
    opt = traffic["optimizer"]
    return {"outer_rounds": opt["outer_rounds"],
            "motion_epochs": opt["motion_epochs"],
            "mu_iters": opt["mu_iters"],
            "learning_rate": opt["learning_rate"],
            "gamma_motion": opt["gamma_motion"],
            "gram_mode": traffic["runtime"].get("gram_mode", "auto")}


def check_frames(limits: dict, t: int, seed: int, extra) -> List[int]:
    n = limits["check_frames"]
    if n == "all" or int(n) >= t:
        chosen = range(t)
    else:
        gen = torch.Generator().manual_seed(int(seed) + 1)
        chosen = torch.randperm(t, generator=gen)[:int(n)].tolist()
    return sorted(set(chosen) | set(extra))


def audit_frames(metrics: list) -> List[int]:
    return [int(m["frame"]) for m in metrics if m.get("phase") == "gram_audit"]


class Reference:
    """The reference's side of the check for one recording."""

    def __init__(self, cell: dict, rec, seed: int, audit_at: List[int],
                 precision: str = "float32"):
        cfg, traffic = cell["config_spec"], cell["traffic_spec"]
        self.ref = spec.load_module("references", cfg["reference"])
        self.ref.set_strict_float32()
        self.sched = schedule(traffic)
        self.gamma = self.sched["gamma_motion"]
        t, k = int(cfg["num_frames"]), int(cfg["num_neurons"])
        dev = rec.pos.device
        self.frames = check_frames(cell["limits"], t, seed, audit_at)
        self.audit = audit_at[0] if audit_at else None
        self.refine = traffic.get("refine")
        idx = torch.tensor(self.frames, device=dev)
        y = rec.rows(idx)
        model = self.ref.Model(cfg["size"], rec.pos, cfg["shape_std"],
                               precision)
        opt_seed = traffic_seed(seed)
        c0 = self.ref.initial_traces(k, t, opt_seed, self.frames, dev)
        self.beta0 = rec.beta0[idx]
        with torch.no_grad():
            self.out = self.ref.follow(
                model, y, self.beta0, c0, self.sched,
                audit_at=(self.frames.index(self.audit)
                          if self.audit is not None else None),
                gram_trust_tol=cell["traffic_spec"]["runtime"].get(
                    "gram_trust_tol", 0.02))
            self.pos = None
            if self.refine is not None:
                polished = self.ref.follow_refine(
                    model, y, self.out["beta"],
                    self.out["c"], self.refine, self.out["gram_mode"])
                self.out["c"] = polished["c"]
                self.pos = polished["pos"]
            self.anchors = rec.pos
            if len(self.frames) == t:
                self.loss = (self.out["mse"].mean(1)
                             + self.gamma * self.out["reg"].mean(1)).tolist()
            else:
                c_all = self.ref.initial_traces(k, t, opt_seed, range(t), dev)
                mse, reg = self.ref.losses(model, rec.beta0, c_all,
                                           rec.frames, self.gamma)
                self.loss = [float(mse.mean() + self.gamma * reg.mean())]

    def view(self) -> dict:
        """The reference's own outputs as :func:`numbers` reads a job's."""
        return {"beta": self.out["beta"], "c": self.out["c"],
                "loss": self.loss, "rel_err": self.out["rel_err"],
                "pos": self.pos}


def traffic_seed(seed: int) -> int:
    """The optimizer's seed of a run (the fit's starting traces)."""
    return int(seed) % (1 << 63)


def job_view(job, frames: List[int], gamma: float) -> dict:
    """A job's outputs at the checked frames."""
    idx = torch.tensor(frames, device=job.beta.device)
    motion = [m for m in job.metrics if m.get("phase") == "motion"]
    audit = [m for m in job.metrics if m.get("phase") == "gram_audit"]
    return {"beta": job.beta[idx], "c": job.c[:, idx],
            "loss": [m["recon_mse"] + gamma * m["reg"] for m in motion],
            "rel_err": audit[0]["rel_err"] if audit else None,
            "pos": None if job.pos_t is None else job.pos_t[idx]}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def numbers(view: dict, reference: Reference) -> dict:
    out = reference.out
    want_epochs = (reference.sched["outer_rounds"]
                   * reference.sched["motion_epochs"])
    if len(view["loss"]) not in (want_epochs, len(reference.loss)):
        loss_err = math.inf
    else:
        loss_err = max(abs(p - r) / abs(r)
                       for p, r in zip(view["loss"], reference.loss))
    d_prog = view["beta"] - reference.beta0
    d_ref = out["beta"] - reference.beta0
    beta_err = torch.max(torch.linalg.vector_norm(
        (d_prog - d_ref).flatten(1), dim=1)
        / torch.linalg.vector_norm(d_ref.flatten(1), dim=1))
    c_err = torch.max(torch.linalg.vector_norm(view["c"] - out["c"], dim=0)
                      / torch.linalg.vector_norm(out["c"], dim=0))
    if reference.sched["gram_mode"] != "auto":
        audit_gap = 0.0
    elif view["rel_err"] is None or out["rel_err"] is None:
        audit_gap = math.inf
    else:
        audit_gap = abs(float(view["rel_err"]) - float(out["rel_err"]))
    readings = {"loss_err": _finite(float(loss_err)),
                "beta_err": _finite(float(beta_err)),
                "c_err": _finite(float(c_err)),
                "audit_gap": _finite(float(audit_gap))}
    if reference.pos is not None:
        readings["pos_err"] = (math.inf if view["pos"] is None else _finite(
            float(pos_err(view["pos"], reference.pos, reference.anchors))))
    return readings


def pos_err(pos: torch.Tensor, pos_ref: torch.Tensor,
            anchors: torch.Tensor) -> torch.Tensor:
    """Per frame ``||(pos - anchors) - (pos_ref - anchors)|| / ||pos_ref -
    anchors||`` of positions ``[F, K, 3]``, the largest over frames."""
    d_ref = (pos_ref - anchors).flatten(1)
    d_prog = (pos - anchors).flatten(1)
    return torch.max(torch.linalg.vector_norm(d_prog - d_ref, dim=1)
                     / torch.linalg.vector_norm(d_ref, dim=1))


def worst(readings: List[dict]) -> dict:
    return {n: max(r[n] for r in readings) for n in NUMBERS
            if n in readings[0]}


def verdict(readings: dict, limits: dict) -> dict:
    """Each number that the limits list beside its limit, and whether all
    are within."""
    lim = limits["limits"]
    names = [n for n in NUMBERS if n in lim]
    checks = {n: {"value": readings.get(n, math.inf), "limit": lim[n]}
              for n in names}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok, "checks": checks}
