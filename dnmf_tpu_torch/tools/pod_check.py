"""Sharded == single-device equalities of the port's parallel layer.

Counterpart of the JAX package's ``tools/pod_check.py``: every sharded
program of :mod:`dnmf_tpu_torch.parallel` runs at a small size on a
process group and is held against the port's single-device functions,
which every rank also runs:

    python -m dnmf_tpu_torch.tools.pod_check --cpu 8    # 8 CPU gloo ranks
    python -m dnmf_tpu_torch.tools.pod_check --cuda 4   # 4 ranks, the cards

``--cuda N`` starts N ranks on the host's cards (rank r on card r modulo
their count) in a ``gloo`` group, whose collectives take CUDA tensors
through the host, so several ranks can share one card; there the
kernels run wherever a check asks for them.  A PASS or FAIL line prints
per check (rank 0; a check fails if it fails on any rank), and the exit
code is non-zero on any FAIL.  :func:`run_all` runs the checks inside an
existing process group.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SIZE = (12, 12, 2)
POS = [[3.0, 3.0, 1.0], [8.0, 3.0, 1.0], [5.0, 8.0, 1.0]]


def _setup(n_time: int, device):
    from dnmf_tpu_torch import config as tcfg
    from dnmf_tpu_torch.models import dnmf as tM

    k = len(POS)
    t = 2 * n_time  # >= 2 frames per rank, so the halo has inner edges
    model = tcfg.ModelConfig(size=SIZE, num_neurons=k, num_frames=t,
                             shape_std=2.0)
    state = tM.init_state(model, positions=POS,
                          generator=torch.Generator().manual_seed(3),
                          device=device)
    p = SIZE[0] * SIZE[1] * SIZE[2]
    video = torch.rand((t, p), generator=torch.Generator().manual_seed(9))
    return model, tM.Adam(1e-3), state, video.to(device)


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu(), np.float64)
                               if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref.detach().cpu(), np.float64)
                               if isinstance(ref, torch.Tensor) else ref,
                               rtol=rtol, atol=atol)


def run_all(device="cpu", verbose: bool = True) -> list:
    """Run the checks on the current process group (the time axis over
    every rank); returns the names of the failed ones, on every rank."""
    from dnmf_tpu_torch import config as tcfg
    from dnmf_tpu_torch import parallel
    from dnmf_tpu_torch.data.streaming import StreamingVideo
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import refine as tR
    from dnmf_tpu_torch.parallel.mesh import video_sharding
    from dnmf_tpu_torch.registration import motion_correct as mc_lib

    n = dist.get_world_size()
    rank0 = dist.get_rank() == 0
    device = torch.device(device)
    model, adam, state, video = _setup(n, device)
    mesh = parallel.make_mesh(num_time=n)
    s_state = parallel.shard_state(state, mesh)
    s_video = parallel.shard_video(video, mesh)
    whole = parallel.gather_state
    failed = []

    def check(name, fn):
        err = ""
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — reported, then the next
            err = str(e).split("\n")[0][:200] or type(e).__name__
        flag = torch.tensor([1.0 if err else 0.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if float(flag) > 0:
            failed.append(name)
        if verbose and rank0:
            print(f"  {'FAIL' if float(flag) > 0 else 'PASS'} {name}"
                  + (f": {err}" if err else ""), flush=True)

    def gather(x, dim=0):
        return parallel.gather_time(x, mesh, dim)

    # 1. The per-frame warp fit: no communication.
    def _motion():
        ref, ref_m = tM.motion_epoch_parallel(state, video, model, adam,
                                              0.1, frame_block=2)
        sh, sh_m = parallel.sharded_motion_epoch(s_state, s_video, model,
                                                 adam, 0.1, mesh,
                                                 frame_block=2)
        _close(whole(sh, mesh).beta, ref.beta, 1e-5, 1e-7)
        _close(float(sh_m["recon_mse"]), float(ref_m["recon_mse"]), 1e-5, 0)
    check("motion epoch (sharded == single)", _motion)

    # 2. Grams: sums over each frame's voxels, no communication.
    grams, c1 = tM.compute_grams(state, video, model, frame_block=2)

    def _grams():
        g, c = parallel.sharded_compute_grams(s_state, s_video, model, mesh,
                                              frame_block=2)
        _close(gather(g), grams, 1e-5, 1e-6)
        _close(gather(c), c1, 1e-5, 1e-6)
    check("trace Grams (sharded == single)", _grams)

    def _grams_analytic():
        ref_g, ref_c = tM.compute_grams(state, video, model, frame_block=2,
                                        gram_mode="analytic")
        g, c = parallel.sharded_compute_grams(
            s_state, s_video, model, mesh, frame_block=2,
            gram_mode="analytic")
        _close(gather(g), ref_g, 1e-5, 1e-6)
        _close(gather(c), ref_c, 1e-5, 1e-6)
    check("analytic Grams (sharded == single)", _grams_analytic)

    f = video_sharding(mesh).frames(grams.shape[0])

    # 3. The smoothed trace update: the +-1-frame halo.
    def _halo():
        ref = tM.footprint_update(state, grams, c1, iters=15, gamma=0.05)
        sh = parallel.sharded_footprint_update(s_state, grams[f], c1[f],
                                               mesh, iters=15, gamma=0.05)
        _close(gather(sh.c, 1), ref.c, 1e-4, 1e-6)
    check("trace halo (sharded == single)", _halo)

    def _fista():
        ref = tM.footprint_update(state, grams, c1, iters=20, gamma=0.05,
                                  solver="fista")
        sh = parallel.sharded_footprint_update(
            s_state, grams[f], c1[f], mesh, iters=20, gamma=0.05,
            solver="fista")
        _close(gather(sh.c, 1), ref.c, 1e-4, 1e-6)
    check("FISTA halo + max Lipschitz (sharded == single)", _fista)

    # 4. The kernels inside the ranks.
    def _kernel_grams():
        g, _ = parallel.sharded_compute_grams(s_state, s_video, model, mesh,
                                              frame_block=2,
                                              use_kernels=True)
        _close(gather(g), grams, 1e-4, 1e-5)
    check(f"kernel Grams in the ranks ({device.type})", _kernel_grams)

    # 5. Per-axis widths [K, 3] replicate; epochs and Grams match.
    def _aniso():
        sig3 = torch.tensor([[1.6, 2.2, 1.1], [2.4, 1.4, 1.3],
                             [1.9, 1.9, 0.9]], device=device)
        st = state.replace(sigma=sig3)
        s_st = parallel.shard_state(st, mesh)
        ref, _ = tM.motion_epoch_parallel(st, video, model, adam, 0.1,
                                          frame_block=2)
        sh, _ = parallel.sharded_motion_epoch(s_st, s_video, model, adam,
                                              0.1, mesh, frame_block=2)
        _close(whole(sh, mesh).beta, ref.beta, 1e-5, 1e-7)
        for gm in ("exact", "analytic"):
            ref_g, ref_c = tM.compute_grams(st, video, model, frame_block=2,
                                            gram_mode=gm)
            g, c = parallel.sharded_compute_grams(s_st, s_video, model, mesh,
                                                  frame_block=2,
                                                  gram_mode=gm)
            _close(gather(g), ref_g, 1e-5, 1e-6)
            _close(gather(c), ref_c, 1e-5, 1e-6)
    check("anisotropic sigma sharded (== single)", _aniso)

    # 6. Voxel-sharded Grams: voxel offsets and a sum over the pixel axis.
    if n % 2 == 0:
        mesh_tp = parallel.make_mesh(num_time=n // 2, num_pixel=2)

        def _tp(use_kernels):
            g, c = parallel.sharded_compute_grams(
                parallel.shard_state(state, mesh_tp),
                parallel.shard_video(video, mesh_tp), model, mesh_tp,
                frame_block=2, use_kernels=use_kernels)
            tol = (1e-4, 1e-5) if use_kernels else (1e-5, 1e-6)
            _close(parallel.gather_time(g, mesh_tp), grams, *tol)
            _close(parallel.gather_time(c, mesh_tp), c1, *tol)
        check("TP pixel-sharded Grams (== dense)", lambda: _tp(False))
        check(f"TP voxel-range kernel Grams ({device.type})",
              lambda: _tp(True))

    # 7. Mesh x host streaming.
    def _streaming():
        src = StreamingVideo(video.cpu().numpy().reshape(
            (video.shape[0],) + SIZE), block=2, device=device)
        st, _ = parallel.sharded_motion_epoch_streaming(
            s_state, src, model, adam, 0.1, mesh)
        ref, _ = tM.motion_epoch_parallel(state, video, model, adam, 0.1,
                                          frame_block=video.shape[0])
        _close(whole(st, mesh).beta, ref.beta, 1e-5, 1e-6)
        g, _ = parallel.sharded_compute_grams_streaming(s_state, src, model,
                                                        mesh)
        _close(gather(g), grams, 1e-5, 1e-6)
        if n % 2 == 0:  # a pixel axis: each rank reads its run of voxels
            tp_state = parallel.shard_state(state, mesh_tp)
            tp_video = parallel.shard_video(video, mesh_tp)
            st, _ = parallel.sharded_motion_epoch_streaming(
                tp_state, src, model, adam, 0.1, mesh_tp, use_kernels=True)
            ref, _ = parallel.sharded_motion_epoch(
                tp_state, tp_video, model, adam, 0.1, mesh_tp, frame_block=2,
                use_kernels=True)
            _close(st.beta, ref.beta, 1e-5, 1e-6)
            g, _ = parallel.sharded_compute_grams_streaming(
                tp_state, src, model, mesh_tp, use_kernels=True)
            ref_g, _ = parallel.sharded_compute_grams(
                tp_state, tp_video, model, mesh_tp, frame_block=2,
                use_kernels=True)
            _close(g, ref_g, 1e-5, 1e-6)
    check("mesh x streaming epoch/Grams (== device-resident)", _streaming)

    # 8. Registration: the chunk templates' median.
    def _registration():
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(0)
        tmpl = gaussian_filter(rng.normal(size=(32, 32)),
                               2.0).astype(np.float32)
        true = [(i % 5 - 2, (i + 2) % 5 - 2) for i in range(2 * n)]
        vid = np.stack([np.roll(tmpl, s, axis=(0, 1)) for s in true])
        cfg = tcfg.RegistrationConfig(max_shifts=(5, 5), niter_rig=2,
                                      splits=n, border_nan=False,
                                      frame_block=1)
        templ_s, _, shifts_s = parallel.sharded_register_rigid(
            vid, cfg, mesh, template=tmpl, device=device)
        templ_b, _, shifts_b, _ = mc_lib._batch_rigid(
            vid, cfg, device, template=torch.as_tensor(tmpl).to(device))
        shifts_all = gather(torch.as_tensor(shifts_s).to(device))
        _close(shifts_all, shifts_b, 0, 1e-4)
        _close(templ_s, templ_b, 0, 1e-4)
    check("sharded registration (== single-device chunked)", _registration)

    # 9. Recordings over a batch axis: each rank runs its recordings at
    # once (the kernels' recordings axis), against each recording's round.
    if n % 2 == 0:
        def _batched():
            mesh_bt = parallel.make_mesh(num_time=n // 2, num_batch=2)
            state1 = tM.init_state(
                model, positions=state.pos + 0.5,
                generator=torch.Generator().manual_seed(2), device=device)
            videos = torch.stack([video, video.flip(0)])
            new, _ = parallel.batched_round(
                parallel.stack_states([state, state1]), videos, model, adam,
                0.1, mu_iters=5, frame_block=2, use_kernels=True,
                mesh=mesh_bt)
            for i, (st, vid) in enumerate(((state, videos[0]),
                                           (state1, videos[1]))):
                st_m, _ = tM.motion_epoch_parallel(st, vid, model, adam, 0.1,
                                                   frame_block=2,
                                                   use_kernels=True)
                g, c = tM.compute_grams(st_m, vid, model, frame_block=2,
                                        use_kernels=True)
                ref = tM.footprint_update(st_m, g, c, iters=5)
                got = parallel.unstack_states(new)[i]
                _close(got.beta, ref.beta, 1e-5, 1e-7)
                _close(got.c, ref.c, 1e-4, 1e-6)
        check("batched recordings round (== per-recording)", _batched)

    # 10. Position refinement: no communication.
    def _refine(use_kernels):
        ref_st, ref_pos, _ = tR.refined_rounds(state, video, model, rounds=1,
                                               epochs=3, mu_iters=3)
        st, pos, _ = parallel.sharded_refined_rounds(
            s_state, s_video, model, mesh, rounds=1, epochs=3, mu_iters=3,
            use_kernels=use_kernels)
        tol = ((1e-4, 1e-5), (1e-3, 1e-5)) if use_kernels else (
            (1e-5, 1e-6), (1e-4, 1e-6))
        _close(gather(pos), ref_pos, *tol[0])
        _close(gather(st.c, 1), ref_st.c, *tol[1])
    check("sharded position refinement (== single)", lambda: _refine(False))
    check(f"sharded kernel refinement ({device.type}; == single plain)",
          lambda: _refine(True))

    if verbose and rank0:
        status = "ALL PASS" if not failed else f"{len(failed)} FAILED"
        print(f"pod_check: {status} ({n} ranks, backend "
              f"{dist.get_backend()}, {device.type})", flush=True)
    return failed


def _rank(rank: int, world: int, address: str, cuda: bool, out) -> None:
    from dnmf_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    local = [rank % torch.cuda.device_count()] if cuda else None
    initialize_distributed(address, world, rank, local_device_ids=local,
                           backend="gloo")
    failed = run_all("cuda" if cuda else "cpu")
    if rank == 0:
        out.put(failed)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--cpu", type=int, metavar="N",
                       help="N CPU ranks in a gloo group")
    group.add_argument("--cuda", type=int, metavar="N",
                       help="N ranks on the host's cards in a gloo group")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    cuda = args.cuda is not None
    world = args.cuda if cuda else args.cpu
    if cuda and not torch.cuda.is_available():
        print("pod_check: --cuda needs a CUDA device", file=sys.stderr)
        return 2
    if cuda:
        from dnmf_tpu_torch.ops import _build

        _build.load()  # one build before the ranks start
    import torch.multiprocessing as mp

    mpc = mp.get_context("spawn")
    out = mpc.SimpleQueue()
    address = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank, args=(world, address, cuda, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + args.timeout
    failed = None
    while True:
        if failed is None and not out.empty():  # drained before the join
            failed = out.get()
        if ctx.join(timeout=2):
            break
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            print(f"pod_check: ranks ran past {args.timeout} s",
                  file=sys.stderr)
            return 1
    if failed is None:
        failed = out.get()
    print(f"pod_check: {time.perf_counter() - t0:.3f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
