"""Registration time breakdown at whole-brain scale (512x512x20) on one GPU.

    python -m dnmf_tpu_torch.tools.reg_bench [--frames 2] [--reps 5]
        [--sections main,probes,fused,apply] [--seed S]

Counterpart of the JAX repo's ``tools/reg_bench.py``: the ms per frame of
each stage of piecewise-rigid registration (4x4x2 patches of
160x160x10, max shifts (6, 6, 2)) on random frames and template, so that
kernel work targets the measured bottleneck.  Each row is timed with CUDA
events, the median of ``--reps`` calls after one warm-up (quartiles and
counts in the last line's ``timing``):

* ``main``: rigid estimate + apply; piecewise-rigid estimate + apply with
  kernel F and the separable remap at rigid decimation 1, 2 and 4, with
  the plain ``torch.fft`` correlation (``phasecorr_impl="xla"``), and with
  kernel G applying the field (``fused_warp_max_abs_diff``: G's movie
  against the separable remap's); the estimate alone;
* ``probes``: patch FFTs alone, per-patch registration with the template
  spectrum made in the call or beforehand, the field's upsampling;
* ``fused``: kernel F's stage with the subpixel refinement (its shift
  error on a template moved by a known subpixel shift) and alone;
* ``apply``: the separable apply and kernel G alone, on given fields.

The JAX rows with no meaning here are left out: the matrix-DFT probes (F
is an FFT), the DFT precision sweep (one float32 path) and G's tile sweep
(the kernel picks its tiles).  The last line is one JSON object with the
rows, the launches of each kernel and the card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from dnmf_tpu_torch.ops import fft_reg, fused, phasecorr, warp
from dnmf_tpu_torch.ops.resample import separable_warp
from dnmf_tpu_torch.registration import motion_correct as mc_lib
from dnmf_tpu_torch.tools import bench
from dnmf_tpu_torch.tools import kernel_check as kc

SIZE = (512, 512, 20)
MAX_SHIFTS = (6, 6, 2)
STRIDES = (128, 128, 10)
OVERLAPS = (32, 32, 0)
MAX_DEV = 3
SECTIONS = ("main", "probes", "fused", "apply")
GT_SHIFT = (2.3, -1.7, 0.6)  # px, the known shift of the fused section


def run(frames: int = 2, reps: int = 5, sections=SECTIONS, size=SIZE,
        strides=STRIDES, overlaps=OVERLAPS, max_shifts=MAX_SHIFTS,
        seed: int = 0, device="cuda", say=print) -> dict:
    """Time the rows of ``sections`` on ``frames`` random frames; returns
    ``{"reg_bench_ms_per_frame": {row: ms}, "timing": {row: quartiles},
    "launches": {kernel: count}}`` (shift errors and the fused warp's
    difference among the rows, unscaled)."""
    dev = torch.device(device)
    gen = bench.seeded_generator(seed, dev)
    b = frames
    frm = bench.uniform(gen, (b,) + tuple(size), dev)
    template = bench.uniform(gen, tuple(size), dev)
    starts, grid_shape, window = mc_lib.patch_grid(size, overlaps, strides)
    say(f"patch grid {grid_shape}, window {window}, {len(starts)} patches")
    lb = torch.tensor([-float(s) for s in max_shifts], device=dev)
    ub = -lb
    results, timing = {}, {}
    fused.reset_launch_counts()

    def report(name, fn, per=b):
        s = kc.summary([x * 1e3 / per for x in kc.event_seconds(
            fn, reps, dev)])
        results[name] = s.pop("median")
        timing[name] = s
        say(f"{name:40s} {results[name]:9.3f} ms/frame")

    def pw(dec, remap="separable", impl="auto"):
        return lambda: mc_lib.tile_and_correct_block(
            frm, template, strides, overlaps, max_shifts,
            max_deviation_rigid=MAX_DEV, upsample_factor_grid=4,
            upsample_factor_fft=10, use_remap=True, remap_mode=remap,
            border_nan=False, rigid_decimate=dec, phasecorr_impl=impl)

    wm, wn, wz = window
    tre, tim = phasecorr.patch_spectra(mc_lib._extract_patches(
        template, starts, window))

    def fused_stage(fr, bounds, usf=10):
        """Kernel F on the block's patches, then (``usf > 1``) the
        subpixel refinement of its peaks, as the fused path runs them."""
        pats = phasecorr.to_zm_n(mc_lib._extract_patches(fr, starts, window))
        sh_int, pre, pim = phasecorr.phase_corr_block(
            pats.contiguous(), tre, tim, bounds, z=wz)
        if usf == 1:
            return sh_int
        prod = torch.complex(pre, pim).reshape(pre.shape[:2] + (wz, wm, wn))
        return fft_reg.subpixel_refine(prod, sh_int, usf, window,
                                       prod_layout=(2, 0, 1))[0]

    def estimate(dec):
        """The fused path's estimate alone: the rigid shifts, F within
        +-MAX_DEV of them and the subpixel refinement."""
        def call():
            rigid = mc_lib._rigid_estimate(frm, template, max_shifts, 10, dec)
            bounds = torch.cat([torch.ceil(rigid - MAX_DEV),
                                torch.floor(rigid + MAX_DEV),
                                torch.zeros_like(rigid[:, :2])], dim=1)
            return fused_stage(frm, bounds)
        return call

    if "main" in sections:
        report("rigid est+apply", lambda: mc_lib.rigid_correct_frames(
            frm, template, max_shifts, upsample_factor=10, border_nan=False))
        for dec in (1, 2, 4):
            report(f"pw-rigid est+apply (sep, dec={dec})", pw(dec))
        report("pw-rigid est+apply (dec=4, torch.fft pc)", pw(4, impl="xla"))
        report("pw-rigid est+apply (dec=4, FUSED warp)", pw(4, "fused"))
        werr = float(torch.max(torch.abs(pw(4, "fused")()[0]
                                         - pw(4)()[0])))
        say(f"    fused-warp max |diff| vs separable: {werr:.2e}")
        results["fused_warp_max_abs_diff"] = werr
        report("pw-rigid estimate only (dec=1)", estimate(1))
        report("pw-rigid estimate only (dec=4)", estimate(4))

    if "probes" in sections:
        def patch_ffts():
            pats = mc_lib._extract_patches(frm, starts, window)
            half = torch.fft.rfftn(pats, dim=(-3, -2, -1))
            return torch.fft.irfftn(half, s=window, dim=(-3, -2, -1)).sum()

        def patch_reg(usf, tmpl_freq=None):
            def call():
                tf = tmpl_freq
                if tf is None:
                    tf = torch.fft.fftn(mc_lib._extract_patches(
                        template, starts, window), dim=(-3, -2, -1))
                src = torch.fft.fftn(mc_lib._extract_patches(
                    frm, starts, window), dim=(-3, -2, -1))
                return fft_reg.correlate(src, tf, lb, ub, usf, 3)[0]
            return call

        tmpl_freq = torch.fft.fftn(mc_lib._extract_patches(
            template, starts, window), dim=(-3, -2, -1))
        report("probe: patch rfft+irfft only", patch_ffts)
        report("probe: patch registration usf=1", patch_reg(1))
        report("probe: patch registration usf=10", patch_reg(10))
        report("probe: + mask/argmax (usf=1, tmpl preFFT)",
               patch_reg(1, tmpl_freq))
        report("probe: + subpixel usf=10 (tmpl preFFT)",
               patch_reg(10, tmpl_freq))
        shifts_p = bench.uniform(gen, (1, len(starts), 3), dev)
        report("probe: field upsample x3 (1 frame)",
               lambda: warp.warp_field_plain(shifts_p, grid_shape, size), 1)

    if "fused" in sections:
        bounds = torch.zeros((b, 8), device=dev)
        bounds[:, :3], bounds[:, 3:6] = lb, ub
        gt = torch.tensor(GT_SHIFT, device=dev)
        shifted = fft_reg.apply_shifts_fourier(template, gt,
                                               border_nan="copy")
        shifted_b = shifted.expand((b,) + tuple(size))
        report("probe: FUSED patch reg usf=10",
               lambda: fused_stage(frm, bounds))
        # A patch's recovered shift is the displacement of its content:
        # the known shift itself.
        err = float(torch.max(torch.abs(fused_stage(shifted_b, bounds) - gt)))
        say(f"    max |shift err| vs known shift: {err:.4f} px")
        results["fused_max_shift_err_px"] = err
        report("probe: FUSED integer stage only",
               lambda: fused_stage(frm, bounds, usf=1))

    if "apply" in sections:
        field = torch.tensor([2.0, -1.5, 0.5], device=dev).expand(
            (b,) + tuple(size) + (3,))
        bound = tuple(int(math.ceil((ms + 3) * 1.3)) + 1 for ms in max_shifts)
        report("separable apply alone",
               lambda: separable_warp(frm, field, bound))
        ps_b = bench.uniform(gen, (b, len(starts), 3), dev)
        rig_b = torch.zeros((b, 3), device=dev)
        report("FUSED apply alone", lambda: warp.fused_separable_warp(
            frm, ps_b, rig_b, grid_shape, size, max_shifts, MAX_DEV))

    launches = fused.launch_counts()
    return {"reg_bench_ms_per_frame": results, "timing": timing,
            "launches": {k: n for k, n in launches.items() if n}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sections", type=str, default="all",
                    help="comma list from {" + ",".join(SECTIONS) + "}")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sections = (SECTIONS if args.sections == "all"
                else tuple(args.sections.split(",")))
    if not torch.cuda.is_available():
        print("reg_bench: no CUDA device; it runs on the card only",
              file=sys.stderr, flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    info = bench.device_info()
    print(info["nvidia_smi"], flush=True)
    out = run(args.frames, args.reps, sections, seed=args.seed,
              say=lambda msg: print(msg, flush=True))
    print(json.dumps({**out, "frames": args.frames, "seed": args.seed,
                      "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
