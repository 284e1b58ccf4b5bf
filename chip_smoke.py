"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. the card: nvidia-smi name and power limit, torch's device name
  2. build the hand-written kernel (csrc/morphology.cu) with nvcc
  3. kernel == its plain PyTorch version, bit for bit, on the card: the
     swap's masks at B=1, 8 and 4 triples, the Poisson composite's
     [B,1024,1024,1] x 30, the --micro CLI's [1,128,128,1] x 30 and the
     training data generators' [6,256,256,1] and [2,256,256,1] x 5
  4. the port's main path: HairFast(HairFastConfig()).warmup, then .swap on
     three distinct seeded 1024^2 images, random full-width zoo in bf16; the
     kernel's launch count over each; a zero-noise f32 run; and the slice at
     128^2 on the card against the same slice on the CPU
  5. times with CUDA events: swap p50 (bf16, B=1), kernel vs plain at both
     shapes, peak memory
  6. where the swap's time goes: stage p50 (CUDA events), host enqueue time,
     torch.profiler's device events, busy time and top kernels per swap
  7. swap_tensor's host steps (coercion, equal_replacer, upload) timed apart
  8. the serving surface at full width in bf16: uint8 and output_res=512
     against the float path, upload_res=512, poisson=True (the composite's
     time and launches), swap_batch at B=8 (transfers/s, peak memory, rows
     against B=1 in f32), swap_stream over 8 PNG triples (and which decoder
     it used), a save_all dump
  9. checkpoint_serve: the full-width f32 zoo saved to a zoo_torch.pt and
     loaded back by HairFast(checkpoint_dir), leaf for leaf; the HTTP server
     over it: /healthz, /swap plain, output_res=512 and poisson=1 within 1
     uint8 step of hf.swap, 400 on a malformed query, 413 on an oversize
     body, the request p50 by the client's clock
 10. train: the training path at full width in f32 on phase 4's f32 zoo:
     the data generators at B=2 (blending, seg16 blending, mask16, rotate
     pair; ms, launches, the JAX row ABI), 1 + 5 blending steps and 1 + 3
     pose / 1 + 3 hair rotate steps (step p50, peak memory, finite losses,
     trainable weights moved, frozen ones untouched), the train state's
     round trip, and micro steps on the card against the CPU (TF32 off)
 11. train_pp: the PostProcess training path at full width, B=2, on the
     same zoo: generate_pp_sample (ms, launches, the JAX row ABI), 1 + 3
     fused encoder steps with the discriminator, 1 + 3 discriminator steps
     and one R1 (p50, peak memory, finite terms, frozen nets untouched),
     1 + 3 steps each in bf16, split and remat, one step under
     torch.profiler, the train state with the discriminator, and micro
     fused and split steps on the card against the CPU (TF32 off)
 12. full-width STAR: landmarks on the card against the CPU, the
     confidence gate raising, an aligned 1500x1200 photo through swap
 13. the CLI (python -m hairfastgan_torch.main --micro --poisson) in a
     subprocess on the card, then the six training scripts (--tiny,
     --device cuda: gen_blending_data -> train_blending, gen_rotate_data ->
     train_rotate, gen_pp_data -> train_pp --use_adv --fid_real_dir) in
     another
 14. eval: the codec-free Keys resize (csrc/resize_u8.cpp) within 1 uint8
     step of the card's bicubic and upload_res_agreement (Keys beside
     LANCZOS); full-width InceptionV3 card vs CPU and its p50;
     fid_metric --device cuda in a subprocess against frechet_distance in
     this process; build_pca_model on the card (orthonormal components,
     p_norm_loss card vs CPU); align_faces --device cuda in a subprocess;
     the parity harness at full width passing a golden of the port's own
     f32 run and failing it once perturbed
 15. parallel: the multi-device layer at full width, on meshes of the
     visible cards, or of the one card repeated ([cuda:0] * n: the math,
     not the speed): swap_batch's per-shard swap at B=4 over 2 (f32 rows
     against B=1 swaps) and swap_batch B=8 over 2 in bf16; the H-band
     sharded swap over 2 and 4 bands against the unbanded swap (f32, the
     BiSeNet labels, the moves, 2 launches; halo=1 load-bearing; bf16 p50
     and peak memory beside the unbanded swap's); a data-parallel blending
     step at 1024^2 and the micro discriminator step in float64 against one
     device, with the stddev groups over the global batch
 16. fastpaths: the opt-ins at full width, each against the default path
     and timed beside it in turns: paired shape modules (f32 zero-noise
     shape modules and swap vs the sequential ones; bf16 p50, device events,
     idle share, peak memory), zoo.pack_zoo (f32 swap vs unpacked; bf16 swap
     and e4e_encode B=3 / fs_encode B=2 / sean_decode B=2 ms and events),
     modulated_conv2d(fuse_blur=True) for every up StyledConv 8^2 -> 1024^2
     (ms, device us, f32 difference), rot_render_pairs=6 / rot_seg_size=512
     (bf16 p50), and scripts/fastpath_agreement --n 16 on the card
 17. model_axis: the full-width generator (1024^2, 18 latents) placed by
     shard_params_model_axis on (1, 2), (1, 4) and (2, 2) meshes of the one
     card repeated and run column-parallel (parallel/tensor.py): mapping,
     generate at B=2, G[0..3] and G[4..8] from F in f32 against the
     unsharded calls (1e-4 of max |y|), the bf16 render (mean |diff| at most
     twice the unsharded bf16 render's own), the exact all_gather counts,
     MeshPlan.spatial()'s H bands, and bf16 p50 and peak memory beside the
     unsharded render's (the math, not multi-card speed)
 18. model_axis_swap: the whole swap at B=2 on phase 4's f32 zoo placed on
     the model axis of (1, 2) and (2, 2) meshes of the one card repeated:
     f32 against the one-device swap (1e-3 of max |y|) and HM_X's labels,
     2 kernel launches per swap at shapes phase 3 checked, moves per swap
     by kind (bf16 the same as f32), bf16 p50 in turns beside the unsharded
     swap, peak memory; on (1, 2) also the paired shape modules, the
     rotate cuts (6 pairs, parsed at 512), a packed zoo (its SEAN gb and
     conv_gb split) and all of them together, each held the same way with
     its bf16 moves; and make_sharded_swap handed the model-axis zoo
     against the banded swap on the whole zoo
Every path is run with the kernel's launch count set to 0 just before it
and read just after; a path that did not launch the kernel fails the run,
and so does a launch at a (shape, dtype, iterations) phase 3 did not check.
The line before the last is the kernel report (JSON); the last line is
{"ok": true, "device": {...}}. Imports no JAX and nothing of the JAX
package; the run fails if either was imported.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

LAUNCHES = {}  # path -> dilate_erode launches while it ran
CHECKED = set()  # (shape, dtype, iterations) phase 3 held bit for bit
SEEN = set()  # (shape, dtype, iterations) the kernel launched at, any phase


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_key(mask, iterations: int) -> tuple:
    return tuple(mask.shape), str(mask.dtype).split(".")[-1], iterations


def record_shapes() -> None:
    """Wrap the kernel's launch so that every (shape, dtype, iterations) it
    runs at lands in SEEN; main() fails unless phase 3 checked each one."""
    from hairfastgan_torch.ops import morphology as M

    launch = M._launch

    def recorded(mask, iterations):
        out = launch(mask, iterations)
        SEEN.add(kernel_key(mask, iterations))
        return out

    M._launch = recorded


def card_info() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def counted(path: str, fn, at_least: int = 1):
    """Run fn with the kernel's launch count set to 0, record the count
    under `path`, and fail unless the kernel launched at least `at_least`
    times."""
    from hairfastgan_torch.ops import morphology as M

    M.dilate_erode.launches = 0
    out = fn()
    LAUNCHES[path] = n = M.dilate_erode.launches
    if n < at_least:
        raise AssertionError(f"{path}: dilate_erode launched {n} times, expected >= {at_least}")
    return out


def cuda_ms(fn, n: int) -> float:
    """Mean device ms per call of fn over n calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_us(fn, n: int) -> float:
    """Device-only microseconds per call of fn (sum of its kernels' times,
    torch.profiler), excluding the host time between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / n


HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores (NVIDIA data sheet)


def dilate_erode_bound(shape, itemsize: int, iterations: int):
    """(ms, "bytes" or "operations"): the least time the card could take for
    dilate_erode at `shape`: one read of the mask and one write of each of
    the two outputs over the HBM rate, or the 4 two-input max (dilate) and 4
    min (erode) per pixel per round over the float32 rate, whichever is
    larger (bytes on a tie)."""
    n = int(np.prod(shape))
    t_bytes = 3 * n * itemsize / HBM_BYTES_PER_S
    t_ops = 8 * iterations * n / F32_OPS_PER_S
    if t_bytes >= t_ops * (1 - 1e-9):  # [1,1024,1024,1] f32 x30 ties to rounding
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def test_masks(shape, seed: int):
    """Random binary masks plus all-zero, all-one, single-pixel,
    border-pixel, disc and sparse masks, each [B,H,W,1]."""
    b, h, w, _ = shape
    rng = np.random.default_rng(seed)
    cases = {"random": (rng.random(shape) > 0.5).astype(np.float32),
             "zeros": np.zeros(shape, np.float32), "ones": np.ones(shape, np.float32)}
    pixel = np.zeros(shape, np.float32)
    pixel[:, h // 2, w // 3] = 1
    border = np.zeros(shape, np.float32)
    border[:, 0, 5] = border[:, h - 1, w - 1] = border[:, 7, 0] = 1
    yy, xx = np.mgrid[:h, :w]
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 3) ** 2).astype(np.float32)
    sparse = (rng.random(shape) > 0.9995).astype(np.float32)
    cases.update(pixel=pixel, border=border, disc=np.broadcast_to(disc[..., None], shape).copy(),
                 sparse=sparse)
    return cases


def phase_kernel(device) -> float:
    """Kernel vs plain version, exact; returns the max abs error (0.0)."""
    import torch

    from hairfastgan_torch.ops import morphology as M

    worst = 0.0
    n = 0
    # the swap's masks at 1/3/5 iterations, the composite's 1024^2 masks at
    # 30, ragged tiles (37 rows, 300 and 3000 columns), swap_batch B=8's and
    # swap_stream batch 4's masks, and the --micro CLI's 128^2 composite
    # the training data generators' at B=2 (the blending sample's 3b masks,
    # generate_mask16's b masks); phase 15's shards and bands launch at
    # shapes already here: [6,...] f32 (B=4 over 2), [12,...] bf16 (B=8
    # over 2) and [3,...] both (a banded swap runs the kernel on the lead)
    shapes = {(3, 256, 256, 1): (1, 3, 5), (1, 256, 256, 1): (1, 3, 5), (2, 37, 300, 1): (1, 3, 5),
              (1, 1024, 1024, 1): (30,), (2, 1024, 1024, 1): (30,), (1, 37, 3000, 1): (30,),
              (24, 256, 256, 1): (5,), (12, 256, 256, 1): (5,), (1, 128, 128, 1): (30,),
              (6, 256, 256, 1): (5,), (2, 256, 256, 1): (5,)}
    for si, (shape, iter_list) in enumerate(shapes.items()):
        for name, m in test_masks(shape, seed=si).items():
            for dtype in (torch.float32, torch.bfloat16):
                for iters in iter_list:
                    x = torch.from_numpy(m).to(device=device, dtype=dtype)
                    d, e = M.dilate_erode(x, iters)
                    d_ref, e_ref = M.dilate_erode_reference(x, iters)
                    torch.cuda.synchronize()
                    err = max((d.float() - d_ref.float()).abs().max().item(),
                              (e.float() - e_ref.float()).abs().max().item())
                    if not (torch.equal(d, d_ref) and torch.equal(e, e_ref)):
                        raise AssertionError(f"kernel != plain: {shape} {name} {dtype} "
                                             f"iters={iters} max_abs_err={err}")
                    if d.dtype != dtype or not d.is_cuda:
                        raise AssertionError(f"kernel output {d.dtype} on {d.device}")
                    worst = max(worst, err)
                    CHECKED.add(kernel_key(x, iters))
                    n += 1
    log(f"[kernel] {n} cases equal bit for bit (shape: iterations {shapes}, f32+bf16)")
    x = torch.zeros((1, 64, 64, 1), device=device)
    try:
        M.dilate_erode(x, 257)  # over the kernel's 256-iteration limit
    except RuntimeError as e:
        log(f"[kernel] 257 iterations raise: {e}")
    else:
        raise AssertionError("the kernel took 257 iterations")
    x = torch.from_numpy(test_masks((1, 256, 256, 1), seed=5)["random"]).to(device)
    if not all(map(torch.equal, M.dilate_erode(x, 5), M.dilate_erode_reference(x, 5))):
        raise AssertionError("the kernel disagrees after a refused launch")
    return worst


def phase_main(device, card: str):
    import torch

    from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
    from hairfastgan_torch.api import HairFast
    from hairfastgan_torch.pipeline.swap import hair_fast
    from hairfastgan_torch.zoo import init_zoo

    cfg = HairFastConfig()
    t0 = time.perf_counter()
    zoo32 = init_zoo(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(zoo32))
    log(f"[main] random full-width zoo: {n_params} params f32 on {device} "
        f"in {time.perf_counter() - t0:.1f} s")
    hf = HairFast(cfg, zoo=zoo32, device=device)  # bf16 (cfg.compute_dtype)
    size = cfg.stylegan.size
    rng = np.random.default_rng(3407)
    imgs = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(3)]

    t0 = time.perf_counter()
    counted("warmup", hf.warmup)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = counted("swap", lambda: hf.swap(*imgs, seed=3407), at_least=2)
    first_s = time.perf_counter() - t0
    launches = LAUNCHES["swap"]
    log(f"[main] warmup() (first swap of zero images: kernel loads, cuDNN picks): "
        f"{warm_s:.2f} s; the first request after it: {first_s:.2f} s; dilate_erode "
        f"launches during the warmup {LAUNCHES['warmup']}, during the swap {launches}")
    if out.shape != (size, size, 3) or out.dtype != np.float32:
        raise AssertionError(f"swap returned {out.shape} {out.dtype}")
    if not (np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
        raise AssertionError("swap output not finite / outside [0,1]")
    if launches != 2:
        raise AssertionError(f"expected 2 kernel launches per swap, counted {launches}")
    dev_out = hf.swap_tensor(*imgs, seed=3407)
    if dev_out.device.type != device.type or tuple(dev_out.shape) != (size, size, 3):
        raise AssertionError(f"swap_tensor gave {dev_out.device} {tuple(dev_out.shape)}")
    log(f"[main] output [{size},{size},3] in [{out.min():.4f}, {out.max():.4f}], "
        f"mean {out.mean():.4f}, computed on {dev_out.device} in {dev_out.dtype}")

    # zero noise, f32, no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = HairFastConfig(compute_dtype="float32")
    hf32 = HairFast(cfg32, zoo=zoo32, device=device)
    trip = [torch.from_numpy(im)[None].to(device) for im in imgs]
    with torch.inference_mode():
        f32 = hair_fast(hf32.zoo, *trip, cfg=cfg32, dtype=torch.float32)[0]
        b16 = hair_fast(hf.zoo, *trip, cfg=cfg, dtype=torch.bfloat16)[0].float()
    if not torch.isfinite(f32).all():
        raise AssertionError("zero-noise f32 swap is not finite")
    bf16_vs_f32 = (b16 - f32).abs()
    log(f"[main] zero-noise f32 swap finite; bf16 vs f32 |diff| max "
        f"{bf16_vs_f32.max().item():.5f} mean {bf16_vs_f32.mean().item():.6f}")
    torch.backends.cudnn.allow_tf32 = True
    del f32, b16

    # the slice at 128^2 (random zoo at that config): card vs the CPU path,
    # which the Tier-1 tests hold against the JAX package
    small = HairFastConfig(stylegan=StyleGANConfig(size=128), compute_dtype="float32")
    zs = init_zoo(small, seed=1)
    srng = np.random.default_rng(7)
    st = [torch.from_numpy(srng.integers(0, 256, (1, 128, 128, 3), dtype=np.uint8))
          for _ in range(3)]
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        cpu = hair_fast(zs, *st, cfg=small, dtype=torch.float32)
        gpu = hair_fast(HairFast(small, zoo=zs, device=device).zoo,
                        *(x.to(device) for x in st), cfg=small, dtype=torch.float32).cpu()
    torch.backends.cudnn.allow_tf32 = True
    small_err = (gpu - cpu).abs().max().item()
    log(f"[main] 128^2 slice, card vs CPU (f32, TF32 off): max |diff| {small_err:.2e}")
    if small_err > 1e-3:
        raise AssertionError(f"card and CPU disagree at 128^2: {small_err}")
    return hf, hf32, imgs, launches


def _leaves(tree):
    import torch

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def phase_times(hf, imgs, device, card: str):
    import torch

    from hairfastgan_torch.ops import morphology as M

    for _ in range(2):  # warm-up
        hf.swap_tensor(*imgs, seed=3407)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 2 ** 30  # both zoos, held for phase 8
    dev_ms, host_ms = [], []
    for i in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = hf.swap_tensor(*imgs, seed=3407 + i)
        end.record()
        out.float().cpu()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    p50 = statistics.median(dev_ms)
    log(f"[times] swap bf16 B=1 p50 {p50:.2f} ms (CUDA events, 10 runs; min "
        f"{min(dev_ms):.2f} max {max(dev_ms):.2f}); host wall incl. result copy p50 "
        f"{statistics.median(host_ms):.2f} ms; peak memory {peak:.2f} GiB, of which "
        f"{resident:.2f} GiB resident before the swaps (the bf16 and f32 zoos)  [{card}]")

    rows = {}
    # the swap's masks (5 iterations) and the composite's (1024^2, 30, f32)
    for shape, iters, dtype in (((3, 256, 256, 1), 5, torch.bfloat16),
                                ((3, 256, 256, 1), 5, torch.float32),
                                ((1, 1024, 1024, 1), 30, torch.float32)):
        masks = test_masks(shape, seed=11)["random" if iters == 5 else "sparse"]
        x = torch.from_numpy(masks).to(device=device, dtype=dtype)
        kern = lambda: M.dilate_erode(x, iters)  # noqa: E731
        plain = lambda: M.dilate_erode_reference(x, iters)  # noqa: E731
        n = 200 if iters == 5 else 50
        for f in (kern, plain):
            cuda_ms(f, 10)  # warm-up
        p1, k1, k2, p2 = (cuda_ms(f, n) for f in (plain, kern, kern, plain))
        kd, pd = device_us(kern, 50), device_us(plain, 10)
        rows[(shape, iters, str(dtype).split(".")[-1])] = ((k1 + k2) / 2, (p1 + p2) / 2, kd, pd)
        log(f"[times] dilate_erode {list(shape)} {dtype} iters={iters}, per call with its "
            f"launch overhead: kernel {(k1 + k2) / 2 * 1e3:.1f} us, plain "
            f"{(p1 + p2) / 2 * 1e3:.1f} us (order plain,kernel,kernel,plain: "
            f"{p1*1e3:.1f} {k1*1e3:.1f} {k2*1e3:.1f} {p2*1e3:.1f}); device-only: kernel "
            f"{kd:.1f} us, plain {pd:.1f} us  [{card}]")
    return p50, peak, rows


def phase_breakdown(hf, imgs, device, card: str) -> None:
    """Where the swap's time goes: each stage of hair_fast('distinct') timed
    by CUDA events over 10 runs, the host's time to enqueue them, and
    torch.profiler's device events over 3 swaps (busy time, idle share,
    the kernels that take the most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hairfastgan_torch.pipeline import alignment as A
    from hairfastgan_torch.pipeline import blending as B
    from hairfastgan_torch.pipeline import embedding as E

    cfg, zoo, dt = hf.cfg, hf.zoo, hf.dtype
    trip = torch.cat([torch.from_numpy(im)[None] for im in imgs]).to(device)
    stages = ("embed", "align", "shape_module", "blend")
    ms = {k: [] for k in stages + ("total", "host_enqueue")}
    with torch.inference_mode():
        for i in range(10):
            g = torch.Generator(device=device)
            g.manual_seed(3407 + i)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            t0 = time.perf_counter()
            ev[0].record()
            emb = E.embed_images(zoo, trip, mix=True, cfg=cfg, dtype=dt)
            face, shape, color = ({k: v[j:j + 1] for k, v in emb.items()} for j in range(3))
            ev[1].record()
            aligned = A.align_images(zoo, face, shape, cfg=cfg, dtype=dt, generator=g)
            ev[2].record()
            sm = A.shape_module(zoo, face, color, cfg=cfg, dtype=dt, generator=g)
            ev[3].record()
            B.blend_images(zoo, aligned, sm, face, color, cfg=cfg, dtype=dt, generator=g)
            ev[4].record()
            ms["host_enqueue"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            for k, a, b in zip(stages, ev, ev[1:]):
                ms[k].append(a.elapsed_time(b))
            ms["total"].append(ev[0].elapsed_time(ev[4]))
    p50 = {k: round(statistics.median(v), 2) for k, v in ms.items()}
    log(f"[breakdown] stage p50 ms (CUDA events, bf16 B=1, 10 runs): {p50}  [{card}]")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            hf.swap_tensor(*imgs, seed=3407 + i)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    n_events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.device_time
            n_events += 1
    busy_ms = sum(by_name.values()) / 3 / 1e3
    log(f"[breakdown] torch.profiler over 3 swaps: {n_events / 3:.0f} device events and "
        f"{busy_ms:.2f} ms device busy per swap; idle share of the stage total p50: "
        f"{1 - busy_ms / p50['total']:.3f}  [{card}]")
    total = sum(by_name.values())
    for name, us in by_name.most_common(12):
        log(f"[breakdown]   {us / 3 / 1e3:7.3f} ms/swap {100 * us / total:5.1f}%  {name[:110]}")


def phase_host_steps(hf, imgs, device, card: str) -> None:
    """swap_tensor's host steps timed apart (p50 over 10 runs each): coercion
    (to_image_u8), equal_replacer, the upload (to the device, synchronized),
    and the rest (hair_fast on the device, synchronized); for the uint8
    arrays of phase 5 and for the same images as PNG paths."""
    import torch
    from PIL import Image

    from hairfastgan_torch.api import equal_replacer, to_image_u8
    from hairfastgan_torch.pipeline.swap import hair_fast, swap_cases

    size = hf.cfg.stylegan.size
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, im in enumerate(imgs):
            paths.append(Path(d) / f"{i}.png")
            Image.fromarray(im).save(paths[-1])
        for label, inputs in (("uint8 arrays", imgs), ("PNG paths", paths)):
            ms = collections.defaultdict(list)
            for i in range(10):
                torch.cuda.synchronize()
                t = [time.perf_counter()]
                u8 = [to_image_u8(im, size) for im in inputs]
                t.append(time.perf_counter())
                rep = equal_replacer(u8)
                t.append(time.perf_counter())
                face, shape, color = hf._upload(rep)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                with torch.inference_mode():
                    hair_fast(hf.zoo, face, shape, color, case=swap_cases(*rep), cfg=hf.cfg,
                              dtype=hf.dtype, generator=hf._generator(3407 + i))
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                hf.swap_tensor(*inputs, seed=3407 + i)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                for k, a, b in zip(("coerce", "equal_replacer", "upload", "hair_fast",
                                    "swap_tensor"), t, t[1:]):
                    ms[k].append((b - a) * 1e3)
            p50 = {k: round(statistics.median(v), 3) for k, v in ms.items()}
            steps = sum(p50[k] for k in ("coerce", "equal_replacer", "upload", "hair_fast"))
            log(f"[host] swap_tensor steps, {label}, p50 ms (host clock, synchronized): {p50}; "
                f"sum of the steps {steps:.3f} vs swap_tensor {p50['swap_tensor']:.3f}  [{card}]")


def phase_serving(hf, hf32, imgs, device, card: str) -> dict:
    """The serving surface at full width in bf16 on phase 4's zoo."""
    import torch

    from hairfastgan_torch.api import HairFast
    from hairfastgan_torch.ops.resample import bicubic_downsample
    from hairfastgan_torch.pipeline.composite import poisson_composite
    from hairfastgan_torch.pipeline.swap import hair_fast

    out = {}
    size = hf.cfg.stylegan.size
    half_res = size // 2  # 512 at full width
    # uint8 and output_res=512 against the float path
    f = counted("swap float", lambda: hf.swap(*imgs, seed=1), at_least=2)
    u8 = counted("swap uint8", lambda: hf.swap(*imgs, seed=1, output="uint8"), at_least=2)
    lsb = int(np.abs(u8.astype(np.int16) - np.clip(f * 255 + 0.5, 0, 255).astype(np.int16)).max())
    half = counted("swap output_res=512", lambda: hf.swap(*imgs, seed=1, output_res=half_res),
                   at_least=2)
    ref = bicubic_downsample(torch.from_numpy(f).to(device).permute(2, 0, 1), 2)
    half_err = (torch.from_numpy(half).to(device) - ref.permute(1, 2, 0)).abs().max().item()
    log(f"[serving] uint8 vs the rounded float output: max {lsb} step(s); output_res={half_res} "
        f"{half.shape} vs the float output downsampled in f32: max |diff| {half_err:.5f}")
    if (u8.dtype != np.uint8 or lsb > 1 or half.shape != (half_res, half_res, 3)
            or half_err > 0.02):
        raise AssertionError(f"uint8 / output_res disagree: {u8.dtype} {lsb} {half.shape} {half_err}")
    up = counted("swap upload_res=512",
                 lambda: hf.swap(*imgs, seed=1, upload_res=half_res, output="uint8"), at_least=2)
    up_diff = np.abs(up.astype(np.int16) - u8.astype(np.int16))
    log(f"[serving] upload_res={half_res}: {up.shape} {up.dtype}; vs full upload mean |diff| "
        f"{up_diff.mean():.3f} u8 steps, max {up_diff.max()}")
    if up.shape != (size, size, 3):
        raise AssertionError(f"upload_res={half_res} gave {up.shape}")

    # poisson=True: the swap plus the composite (BiSeNet x2 at 1024^2, the
    # kernel at [1,1024,1024,1] x 30, 4 x 115 Jacobi sweeps)
    pois = counted("swap poisson=True", lambda: hf.swap(*imgs, seed=1, poisson=True), at_least=3)
    if pois.shape != (size, size, 3) or not np.isfinite(pois).all():
        raise AssertionError(f"poisson swap gave {pois.shape}")
    final = hf.swap_tensor(*imgs, seed=1)[None].float()
    face01 = torch.from_numpy(imgs[0])[None].to(device).float() / 255.0
    comp_ms = []
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.inference_mode():
            poisson_composite(hf.zoo, final, face01)
        end.record()
        torch.cuda.synchronize()
        comp_ms.append(start.elapsed_time(end))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.inference_mode():
        poisson_composite(hf.zoo, final, face01)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["composite"] = (statistics.median(comp_ms[1:]), len(dev),
                        sum(e.device_time for e in dev) / 1e3)
    log(f"[serving] poisson=True: output finite in [{pois.min():.4f}, {pois.max():.4f}]; "
        f"poisson_composite p50 {out['composite'][0]:.2f} ms (CUDA events, 3 runs after one), "
        f"{len(dev)} device kernels, {out['composite'][2]:.2f} ms device busy  [{card}]")

    # swap_batch at B=8: transfers/s, peak memory
    rng = np.random.default_rng(8)
    trip8 = [rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8) for _ in range(3)]
    counted("swap_batch B=8", lambda: hf.swap_batch(*trip8, output="uint8"), at_least=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 2 ** 30
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = hf.swap_batch(*trip8, output="uint8")
        wall.append(time.perf_counter() - t0)
    peak8 = torch.cuda.max_memory_allocated(device) / 2 ** 30
    out["batch8"] = (8 / statistics.median(wall), statistics.median(wall) * 1e3, peak8)
    log(f"[serving] swap_batch B=8 uint8: {res.shape} in p50 {out['batch8'][1]:.1f} ms (host "
        f"wall incl. upload and result copy, 3 runs after one): {out['batch8'][0]:.2f} "
        f"transfers/s; peak memory {peak8:.2f} GiB, of which {resident:.2f} GiB resident "
        f"before  [{card}]")
    # rows of B=8 against B=1 of the same triple: zero noise, f32, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    t8 = [torch.from_numpy(a).to(device) for a in trip8]
    with torch.inference_mode():
        b8 = hair_fast(hf32.zoo, *t8, cfg=hf32.cfg, dtype=torch.float32)
        rows = [(b8[j] - hair_fast(hf32.zoo, *(t[j:j + 1] for t in t8), cfg=hf32.cfg,
                                   dtype=torch.float32)[0]).abs().max().item() for j in (0, 7)]
    torch.backends.cudnn.allow_tf32 = True
    log(f"[serving] B=8 rows 0 and 7 vs B=1 runs (zero noise, f32, TF32 off): max |diff| "
        f"{rows[0]:.3e}, {rows[1]:.3e}")
    if max(rows) > 1e-3:
        raise AssertionError(f"B=8 rows differ from B=1: {rows}")
    del b8, t8

    # swap_stream over 8 PNG triples in a temp directory
    with tempfile.TemporaryDirectory() as d:
        from PIL import Image

        files = []
        for i in range(6):
            files.append(Path(d) / f"{i}.png")
            Image.fromarray(trip8[i % 3][i]).save(files[-1])
        triples = [(files[i % 6], files[(i + 1) % 6], files[(i + 2) % 6]) for i in range(8)]
        t0 = time.perf_counter()
        got = counted("swap_stream", lambda: list(hf.swap_stream(
            triples, depth=2, output="uint8", batch=4)), at_least=2)
        stream_s = time.perf_counter() - t0
    if [i for i, _ in got] != list(range(8)) or any(
            r is None or r.shape != (size, size, 3) for _, r in got):
        raise AssertionError("swap_stream gave the wrong results")
    out["stream"] = 8 / stream_s
    log(f"[serving] swap_stream: 8 triples (batch 4, depth 2) in {stream_s:.2f} s, "
        f"{out['stream']:.2f} triples/s incl. decode; loader: {hf.stream_loader}  [{card}]")
    if hf.stream_loader == "PIL":
        from hairfastgan_torch.data import native_loader

        log(f"[serving] the native loader did not load: {native_loader.native_error()}")

    # one save_all dump
    with tempfile.TemporaryDirectory() as d:
        cfg = dataclasses.replace(hf.cfg, save_all=True, save_all_dir=Path(d))
        dbg = HairFast(cfg, zoo=hf.zoo, device=device)
        counted("save_all", lambda: dbg.swap(*imgs, exp_name="smoke"), at_least=2)
        dumped = sorted(str(p.relative_to(d)) for p in Path(d).rglob("*.*"))
    log(f"[serving] save_all dump: {dumped}")
    if len(dumped) != 9:
        raise AssertionError(f"save_all wrote {dumped}")
    return out


def _post_swap(base: str, body: bytes, ctype: str, query: str = ""):
    """POST /swap -> (status, response bytes, the server's step times in ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{base}/swap{query}", data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            timing = r.headers.get("Server-Timing", "")
            steps = {k: float(v) for k, v in (p.split(";dur=") for p in timing.split(", "))}
            return r.status, r.read(), steps
    except urllib.error.HTTPError as e:
        return e.code, e.read(), {}


def phase_checkpoint_serve(zoo32, imgs, device, card: str, swap_p50: float) -> dict:
    """The full-width f32 zoo through the port's zoo file (save, then
    HairFast loading checkpoint_dir) and the HTTP server over that HairFast:
    /healthz, /swap plain, output_res=512 and poisson=1 against hf.swap on
    the same arrays, a malformed query and an oversize body."""
    import http.client
    import io
    import shutil
    import threading

    import torch
    from PIL import Image

    from hairfastgan_torch import serve
    from hairfastgan_torch.api import HairFast
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.params.checkpoint import ZOO_FILE, save_zoo
    from hairfastgan_torch.zoo import cast_zoo

    out = {}
    cfg = HairFastConfig()
    tmp = tempfile.mkdtemp(prefix="zoo_torch_")
    try:
        free = shutil.disk_usage(tmp).free / 2 ** 30
        log(f"[checkpoint] saving the f32 zoo to {tmp} ({free:.1f} GiB free there)")
        t0 = time.perf_counter()
        path = save_zoo(tmp, zoo32)
        out["save_s"] = time.perf_counter() - t0
        size = path.stat().st_size / 2 ** 30
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hf = HairFast(dataclasses.replace(cfg, checkpoint_dir=Path(tmp)), device=device)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        ref = dict(_flat(cast_zoo(zoo32, torch.bfloat16)))
        got = dict(_flat(hf.zoo))
        if got.keys() != ref.keys():
            raise AssertionError("the loaded zoo's tree differs from the saved one's")
        unequal = [p for p, v in ref.items() if not (
            torch.equal(got[p], v) if isinstance(v, torch.Tensor) else got[p] == v)]
        if unequal or any(v.device.type != device.type for v in _leaves(hf.zoo)):
            raise AssertionError(f"loaded leaves differ from the saved zoo's bf16 cast: {unequal[:5]}")
        log(f"[checkpoint] {ZOO_FILE}: {size:.2f} GiB written in {out['save_s']:.2f} s; "
            f"HairFast(checkpoint_dir) loaded it (memory-mapped, onto the card, bf16 cast) in "
            f"{out['load_s']:.2f} s; all {len(ref)} leaves equal the saved zoo's bf16 cast  "
            f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    srv = serve.build_server(hf, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        import urllib.request

        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        name = torch.cuda.get_device_name(0)
        if health.get("status") != "ok" or not any(name in d for d in health["devices"]):
            raise AssertionError(f"/healthz does not name {name}: {health}")
        log(f"[checkpoint] /healthz: {health}")

        pngs = []
        for im in imgs:
            buf = io.BytesIO()
            Image.fromarray(im).save(buf, format="PNG")
            pngs.append(buf.getvalue())
        boundary = "smokeBoundary7MA4YWxk"
        body = b"".join(
            b"--" + boundary.encode() + b"\r\nContent-Disposition: form-data; name=\"" +
            k.encode() + b"\"; filename=\"" + k.encode() + b".png\"\r\nContent-Type: image/png"
            b"\r\n\r\n" + data + b"\r\n" for k, data in zip(serve.FIELDS, pngs))
        body += b"--" + boundary.encode() + b"--\r\n"
        ctype = f"multipart/form-data; boundary={boundary}"
        worst, size = 0, cfg.stylegan.size
        half = size // 2  # 512 at full width
        for label, query, kw, launches, shape in (
                ("plain", "", {}, 2, (size, size, 3)),
                (f"output_res={half}", f"?output_res={half}", {"output_res": half}, 2,
                 (half, half, 3)),
                ("poisson=1", "?poisson=1", {"poisson": True}, 3, (size, size, 3))):
            status, data, _ = counted(f"/swap {label}",
                                      lambda: _post_swap(base, body, ctype, query),
                                      at_least=launches)
            if status != 200:
                raise AssertionError(f"/swap {label}: HTTP {status} {data[:200]!r}")
            served = np.asarray(Image.open(io.BytesIO(data)))
            direct = hf.swap(*imgs, output="uint8", **kw)
            diff = int(np.abs(served.astype(np.int16) - direct.astype(np.int16)).max())
            worst = max(worst, diff)
            if served.shape != shape or diff > 1 or LAUNCHES[f"/swap {label}"] != launches:
                raise AssertionError(f"/swap {label}: {served.shape}, {diff} steps from hf.swap, "
                                     f"{LAUNCHES[f'/swap {label}']} launches")
        log(f"[checkpoint] /swap plain, output_res={half}, poisson=1: PNGs of the right "
            f"shapes, max {worst} uint8 step(s) from hf.swap on the same arrays; dilate_erode "
            f"launches per request {LAUNCHES['/swap plain']}, "
            f"{LAUNCHES[f'/swap output_res={half}']}, {LAUNCHES['/swap poisson=1']}")

        status, _, _ = _post_swap(base, body, ctype, "?upload_res=abc")
        if status != 400:
            raise AssertionError(f"upload_res=abc gave HTTP {status}")
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        try:
            conn.putrequest("POST", "/swap")
            conn.putheader("Content-Type", ctype)
            conn.putheader("Content-Length", str(serve.MAX_BODY + 1))
            conn.endheaders()
            over = conn.getresponse().status
        finally:
            conn.close()
        if over != 413:
            raise AssertionError(f"a body over the cap gave HTTP {over}")
        log(f"[checkpoint] upload_res=abc -> 400; Content-Length {serve.MAX_BODY + 1} -> 413 "
            f"(not read)")

        wall, steps = [], collections.defaultdict(list)
        for _ in range(5):
            t0 = time.perf_counter()
            status, _, timing = _post_swap(base, body, ctype)
            wall.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"/swap gave HTTP {status}")
            for k, v in timing.items():
                steps[k].append(v)
        out["request_p50_ms"] = statistics.median(wall)
        split = {k: round(statistics.median(v), 2) for k, v in steps.items()}
        log(f"[checkpoint] /swap request p50 {out['request_p50_ms']:.1f} ms over 5 requests "
            f"(client clock: multipart upload of three {size}^2 PNGs, decode, swap, PNG encode, "
            f"response; min {min(wall):.1f} max {max(wall):.1f}) vs swap p50 {swap_p50:.2f} ms "
            f"(phase times, CUDA events); the server's steps, p50 ms (Server-Timing): {split}  "
            f"[{card}]")

        # the same hf.swap by the host's clock: warm in this thread, and each
        # in a new thread (PyTorch keeps cuDNN's execution plans per thread)
        def timed():
            t0 = time.perf_counter()
            hf.swap(*imgs, output="uint8")
            return (time.perf_counter() - t0) * 1e3

        here = statistics.median(timed() for _ in range(3))
        fresh = []
        for _ in range(2):
            th = threading.Thread(target=lambda: fresh.append(timed()))
            th.start()
            th.join()
        log(f"[checkpoint] hf.swap uint8 by the host's clock: {here:.1f} ms warm in the main "
            f"thread (p50 of 3), {fresh[0]:.1f} and {fresh[1]:.1f} ms each in a new thread; "
            f"served swap step p50 {split['swap']:.1f} ms on the server's worker  [{card}]")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    # the server's request-handler class holds hf and, as every class, sits
    # in a reference cycle: without a collection its bf16 zoo stays on the
    # card through the later phases
    del hf, srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _flat(tree, prefix=()):
    """(path, leaf) over dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def phase_star(hf, device, card: str) -> float:
    """Full-width STAR (WFLW, 4 stacks x 4 levels x 256 channels, random
    weights): the card against the CPU, the gate, an aligned swap."""
    import torch

    from hairfastgan_torch.models.star import star_landmarks_nchw
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.utils import face_align
    from hairfastgan_torch.zoo import cast_zoo, init_star

    star = init_star(seed=0, device=device)
    x = torch.from_numpy(np.random.default_rng(9).random((1, 3, 256, 256), dtype=np.float32))
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        lm_g, sp_g = star_landmarks_nchw(star, x.to(device) * 2 - 1, with_spread=True)
        lm_c, sp_c = star_landmarks_nchw(map_tree(star, lambda _, t: t.cpu()), x * 2 - 1,
                                         with_spread=True)
    torch.backends.cudnn.allow_tf32 = True
    err = max((lm_g.cpu() - lm_c).abs().max().item() / lm_c.abs().max().item(),
              (sp_g.cpu() - sp_c).abs().max().item() / sp_c.abs().max().item())
    xs = x.to(device) * 2 - 1
    with torch.inference_mode():
        star_ms = cuda_ms(lambda: star_landmarks_nchw(star, xs, with_spread=True), 5)
        star_ms = cuda_ms(lambda: star_landmarks_nchw(star, xs, with_spread=True), 20)
    log(f"[star] landmarks [1,98,2] card vs CPU (f32, TF32 off): max |diff| {err:.2e} of scale; "
        f"one 256^2 pass {star_ms:.2f} ms (CUDA events, 20 runs)  [{card}]")
    if err > 2e-4:
        raise AssertionError(f"STAR card vs CPU: {err}")

    rng = np.random.default_rng(10)
    photos = [rng.integers(0, 256, (1500, 1200, 3), dtype=np.uint8) for _ in range(3)]
    try:
        face_align.star_landmark_provider(star)(photos[0].astype(np.float32) / 255.0)
    except face_align.AlignmentError as e:
        log(f"[star] the gate raises on random weights: {str(e)[:100]}...")
    else:
        raise AssertionError("the STAR gate passed random weights")
    orig = face_align.star_landmark_provider
    hf.zoo["star"] = cast_zoo(star, hf.dtype)
    face_align.star_landmark_provider = lambda p, **kw: orig(p, **dict(kw, check=False))
    try:
        t0 = time.perf_counter()
        out = counted("swap align=True", lambda: hf.swap(*photos, seed=1, align=True),
                      at_least=2)
        align_s = time.perf_counter() - t0
    finally:
        face_align.star_landmark_provider = orig
        del hf.zoo["star"]
    size = hf.cfg.stylegan.size
    if out.shape != (size, size, 3) or not np.isfinite(out).all():
        raise AssertionError(f"aligned swap gave {out.shape}")
    log(f"[star] gate off: three 1500x1200 photos aligned and swapped in {align_s:.2f} s "
        f"(host clock: 6 STAR passes, the FFHQ crops on the host, the swap)  [{card}]")
    return star_ms


def _lively(tree, key=None):
    """Norm gammas and StyleGAN modulation biases of a random tree shifted by
    +1 (their real initial values), so signals carry through deep nets; the
    tree is changed in place and returned."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "gamma" and isinstance(v, torch.Tensor):
                v.add_(1.0)
            elif k == "modulation":
                v["b"].add_(1.0)
            else:
                _lively(v, k)
    elif isinstance(tree, list):
        for v in tree:
            _lively(v)
    return tree


def _blocky(rng, b, n, ch=3, lo=-1.0, hi=1.0):
    """[b,256,256,ch] images of n x n blocks of uniform values."""
    x = rng.uniform(lo, hi, (b, n, n, ch)).astype(np.float32)
    return np.repeat(np.repeat(x, 256 // n, 1), 256 // n, 2)


def _event_ms(fn):
    """(fn's result, its device ms between CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def row_abi(cfg, b: int):
    """The JAX package's row shapes at `cfg` and batch b: the blending row
    (hairfastgan_tpu/train/blending.py's batch layout) and the rotate pair
    (train/datagen.generate_rotate_pair)."""
    n, img, mask = cfg.stylegan.n_latent, (b, 256, 256, 3), (b, 256, 256, 1)
    blend = {"color_s": (b, n, 512), "align_s": (b, n, 512),
             "align_f": (b, 32, 32, cfg.stylegan.channels(32)), "color_i": img, "face_i": img,
             "target_mask": mask, "HM_3E": mask, "HM_XE": mask}
    return blend, {"W_from": (b, n, 512), "W_to": (b, n, 512), "I_from": img, "I_to": img}


def _timed_steps(label, steps, device):
    """Run (name, fn) steps; p50 ms per name by CUDA events (the first call
    of each name is a warm-up), peak memory, memory resident before, auxs."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 2 ** 30
    ms, auxs = collections.defaultdict(list), []
    for name, fn in steps:
        aux, t = _event_ms(fn)
        ms[name].append(t)
        auxs.append(aux)
        if not all(torch.isfinite(v).all() for v in aux.values()):
            raise AssertionError(f"{label} {name}: non-finite {aux}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    p50 = {k: statistics.median(v[1:]) for k, v in ms.items()}
    return p50, peak, resident, auxs


def _profiled_step(fn):
    """(device events, device busy ms) of one call of fn (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ev), sum(e.device_time for e in ev) / 1e3


def _check_frozen(label, frozen, snapshot, params, before):
    """Every trainable leaf moved; every frozen leaf equal to its snapshot,
    requires_grad False and without .grad."""
    import torch

    from hairfastgan_torch.train.common import tensor_leaves

    moved = [not torch.equal(a, b) for a, b in zip(tensor_leaves(params), before)]
    untouched = all(t.grad is None and not t.requires_grad and torch.equal(t, s)
                    for t, s in zip(tensor_leaves(frozen), snapshot))
    if not all(moved) or not untouched:
        raise AssertionError(f"{label}: {sum(moved)}/{len(moved)} trainable leaves moved; "
                             f"frozen leaves untouched: {untouched}")


def phase_train(zoo32, device, card: str, cfg=None) -> dict:
    """The training path at full width in f32 on phase 4's f32 zoo:
    datagen (blending, seg16 blending, rotate pair, mask16) at B=2, 5
    blending steps, 3 pose + 3 hair rotate steps (full G[0..8] at 1024^2,
    STAR keypoints, IR-SE-50 identity), the train state's round trip, and a
    micro blending step and rotate pose step on the card against the CPU."""
    import shutil

    import torch

    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.models import bisenet
    from hairfastgan_torch.models import star as S
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.params.checkpoint import restore_train_state, save_train_state
    from hairfastgan_torch.train import datagen as D
    from hairfastgan_torch.train.blending import make_blending_train_step
    from hairfastgan_torch.train.common import MovingAverageLoss, tensor_leaves
    from hairfastgan_torch.train.rotate import make_rotate_train_steps
    from hairfastgan_torch.zoo import fill_random, init_arcface, init_star

    out = {}
    cfg = cfg or HairFastConfig()
    blend_row, rotate_row = row_abi(cfg, 2)
    tf32 = (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(4)
    size = cfg.stylegan.size
    face, shape, color = (torch.from_numpy(rng.random((2, size, size, 3), np.float32)).to(device)
                          for _ in range(3))
    seg16 = fill_random(bisenet.init_bisenet(n_classes=16), 3, device)  # seg.pth's shapes
    star = init_star(seed=0, device=device)

    # datagen: ms per call (p50 of 3 after one), launches per call, row ABI
    gens = {"generate_blending_sample": lambda: D.generate_blending_sample(
                zoo32, face, shape, color, cfg),
            "generate_blending_sample(seg16)": lambda: D.generate_blending_sample(
                zoo32, face, shape, color, cfg, seg16_params=seg16),
            "generate_mask16": lambda: D.generate_mask16(seg16, face * 2 - 1, cfg.smooth),
            "generate_rotate_pair": lambda: D.generate_rotate_pair(zoo32, face, shape, cfg)}
    rows = {}
    for name, fn in gens.items():
        rows[name] = counted(f"datagen {name}", fn, at_least=0)
        ms = []
        for _ in range(3):
            ms.append(counted(f"datagen {name}", lambda: _event_ms(fn), at_least=0)[1])
        n = LAUNCHES[f"datagen {name}"]
        # align_images' soft masks and the blend masks: one [3b] launch each
        want = {"generate_mask16": 1, "generate_rotate_pair": 0}.get(name, 2)
        if n != want:
            raise AssertionError(f"{name}: {n} dilate_erode launches per call, expected {want}")
        out[name] = (statistics.median(ms), n)
        log(f"[train] {name} B=2 f32: p50 {out[name][0]:.2f} ms (CUDA events, 3 calls after "
            f"one), dilate_erode launches per call {n}  [{card}]")
    for name, abi in (("generate_blending_sample", blend_row),
                      ("generate_blending_sample(seg16)", blend_row),
                      ("generate_rotate_pair", rotate_row)):
        got = {k: tuple(v.shape) for k, v in rows[name].items()}
        bad = [k for k, v in rows[name].items() if v.dtype != torch.float32
               or not torch.isfinite(v).all()]
        if got != abi or bad:
            raise AssertionError(f"{name} rows {got} (non-finite or not f32: {bad}), "
                                 f"expected {abi}")
    hm = [tuple(t.shape) for t in rows["generate_mask16"]]
    if hm != [(2, 256, 256, 1)] * 2:
        raise AssertionError(f"generate_mask16 gave {hm}")
    log(f"[train] rows of the JAX row ABI, finite f32: blending {blend_row}; rotate {rotate_row}")

    # 5 blending steps at B=2 on the generator's rows
    frozen = {"generator": zoo32["generator"], "clip": zoo32["blending"]["clip"]}
    params = {"mods": map_tree(zoo32["blending"]["mods"], lambda _, t: t.clone())}
    snapshot = [t.clone() for t in tensor_leaves(frozen)]
    before = [t.clone() for t in tensor_leaves(params)]
    step, tx = make_blending_train_step(frozen, cfg)
    opt = tx.init(params)
    row = rows["generate_blending_sample"]
    batch = tuple(row[k] for k in blend_row)
    p50, peak, resident, auxs = _timed_steps("blending", [
        ("step", lambda: step(params, opt, *batch)[2]) for _ in range(6)], device)
    _check_frozen("blending", frozen, snapshot, params, before)
    out["blend"] = (p50["step"], peak, resident)
    log(f"[train] blending: 1 + 5 steps B=2 f32 at 1024^2: step p50 {p50['step']:.2f} ms (CUDA "
        f"events, the 5 after the first); losses {[round(float(a['loss']), 5) for a in auxs]}, "
        f"grad_norm {[round(float(a['grad_norm']), 5) for a in auxs]}; peak memory {peak:.2f} "
        f"GiB, of which {resident:.2f} GiB resident before; mods moved, generator and CLIP "
        f"untouched with no .grad; {tf32}  [{card}]")
    del snapshot, before, opt, params

    # 3 pose + 3 hair rotate steps (each after one warm-up of its kind)
    frozen = {"generator": zoo32["generator"], "arcface": init_arcface(seed=1, device=device),
              "star": star}
    params = map_tree(zoo32["rotate"], lambda _, t: t.clone())
    rot = rows["generate_rotate_pair"]
    with torch.no_grad():
        kp_to = S.keypoints_256(star, rot["I_to"])
    pose_b = (rot["I_from"], kp_to, rot["W_from"], rot["W_to"])
    w_mix = torch.cat([rot["W_to"][:, :6], rot["W_from"][:, 6:]], dim=1)
    hair_b = (w_mix, rot["W_from"])
    snapshot = [t.clone() for t in tensor_leaves(frozen)]
    before = [t.clone() for t in tensor_leaves(params)]
    pose, hair, tx = make_rotate_train_steps(
        frozen, lambda fr, img: S.keypoints_256(fr["star"], img), cfg)
    opt = tx.init(params)
    mal = MovingAverageLoss({"mse_points": 6.0, "mse_latents": 2.0})

    def pose_step():
        aux = pose(params, opt, *pose_b, mal.multipliers(("mse_points", "arc_face")))[2]
        mal.update({k: float(aux[k]) for k in ("mse_points", "arc_face")})
        return aux

    def hair_step():
        aux = hair(params, opt, *hair_b, mal.multipliers(("mse_latents",)))[2]
        mal.update({"mse_latents": float(aux["mse_latents"])})
        return aux

    p50, peak, resident, auxs = _timed_steps("rotate", [
        s for _ in range(4) for s in (("pose", pose_step), ("hair", hair_step))], device)
    _check_frozen("rotate", frozen, snapshot, params, before)
    out["rotate"] = (p50["pose"], p50["hair"], peak, resident)
    log(f"[train] rotate: 1 + 3 pose and 1 + 3 hair steps alternating, B=2 f32, full G[0..8] "
        f"at 1024^2 + STAR + IR-SE-50: pose step p50 {p50['pose']:.2f} ms, hair step p50 "
        f"{p50['hair']:.2f} ms (CUDA events, the 3 after the first of each); pose losses "
        f"{[round(float(a['loss']), 4) for a in auxs[::2]]}; peak memory {peak:.2f} GiB, of "
        f"which {resident:.2f} GiB resident before; rotate mods moved, generator, IR-SE-50 and "
        f"STAR untouched with no .grad; {tf32}  [{card}]")

    # one more pose and hair step under torch.profiler: device events and
    # busy time per step, beside the step's p50
    for name, fn in (("pose", pose_step), ("hair", hair_step)):
        n, busy = _profiled_step(fn)
        out[f"profile_{name}"] = (n, busy, p50[name])
        log(f"[train] rotate {name} step under torch.profiler: {n} device events, "
            f"{busy:.2f} ms device busy of the {p50[name]:.2f} ms step p50 (busy share "
            f"{busy / p50[name]:.3f})  [{card}]")

    # the train state's round trip onto the card
    tmp = tempfile.mkdtemp(prefix="train_state_")
    try:
        sd = opt.state_dict()
        save_train_state(Path(tmp) / "last", params, sd, 8)
        state = restore_train_state(Path(tmp) / "last", device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    moments = [(i, k) for i, s in sd["state"].items() for k in ("exp_avg", "exp_avg_sq", "step")]
    equal = (state["step"] == 8 and all(torch.equal(a, b) and a.device == b.device for a, b in
                                        zip(tensor_leaves(state["params"]), tensor_leaves(params)))
             and all(torch.equal(state["opt_state"]["state"][i][k].cpu(), sd["state"][i][k].cpu())
                     for i, k in moments))
    if not equal:
        raise AssertionError("the restored train state differs from the saved one")
    log(f"[train] train state: saved and restored onto {device}, {len(tensor_leaves(params))} "
        f"params and {len(moments)} Adam moment/step tensors equal leaf for leaf")
    del opt, params, snapshot, before
    torch.cuda.empty_cache()

    out["card_vs_cpu"] = _train_card_vs_cpu(device)
    return out


# Limit on max |d grad| / max |grad| between the card's f32 STAR pose step
# and the CPU's float64 one. The f32 gradient of a random STAR strays from
# float64 by itself: on an x86 CPU, the f32 readings over STAR seeds 0-7 of
# the micro step below ran 4.5e-5 to 1.73e-3 (the `train` phase prints them
# each run), so the limit is about twice the largest.
STAR_F32_GRAD_LIMIT = 4e-3


def _train_card_vs_cpu(device) -> dict:
    """One blending step and two rotate pose steps at a micro config (64^2
    generator at 128 channels, CLIP 64 x 2, IR-SE-50 at width 0.25), the
    same weights and inputs on the card and the CPU, TF32 off: max |d loss|
    / |loss|, max |d grad| / max |grad| (limit 1e-4 each) and max |d param|
    after the Adam step (limit lr/5).

    The IR-SE backbone's output BN is set to the statistics of its
    embeddings of a few images: a random backbone embeds every image along
    nearly one direction, and the gradient of 1 - cos at cos ~ 1 is f32
    noise. One pose step reads keypoints off a pixel grid; the other runs
    STAR (2 stacks x 2 levels x 8 channels, seed 2). A random STAR's f32
    gradient strays from float64 by up to ~1e-3 (its heatmaps are nearly
    flat, so a landmark's gradient is a small difference of large sums),
    so two f32 runs need not agree within 1e-4. The STAR step is therefore
    held twice against a float64 run on the CPU: the card's float64 run at
    the limits above, and the card's f32 run at STAR_F32_GRAD_LIMIT on the
    gradients. The CPU's own f32 gap to float64 over STAR seeds 0-7 is
    printed beside it.

    Gradients are compared relative to max |grad|, so the loss scale drops
    out of them. The pose steps run at 1e-3 of MovingAverageLoss's (0.7,
    1.3): Adam's first step moves a coordinate by lr * g / (|g| + 1e-8), so
    at full scale the few coordinates whose gradient is ~1e-8 move by up to
    lr on a sign flip of their f32 noise; at 1e-3 of it every coordinate's
    step stays linear in g."""
    import torch

    from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
    from hairfastgan_torch.losses.identity import init_irse_backbone
    from hairfastgan_torch.models import clip_vit, encoders, star, stylegan2
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.train import blending as TB
    from hairfastgan_torch.train import rotate as TR
    from hairfastgan_torch.train.common import tensor_leaves
    from hairfastgan_torch.zoo import fill_random

    lr = 1e-3
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=64, max_channels=128))
    clip = clip_vit.init_clip_image_tower(width=64, layers=2, embed_dim=512)
    w = _lively(fill_random({
        "generator": stylegan2.init_generator_params(cfg.stylegan), "clip": clip,
        "blend": {"mods": encoders.init_blending_model(clip)["mods"]},
        "rotate": encoders.init_rotate_model(),
        "arcface": init_irse_backbone(width=0.25)}, 2))

    def micro_star(seed):
        return _lively(fill_random(star.init_star(nstack=2, nlevels=2, channels=8), seed))

    w["star"] = micro_star(2)
    rng = np.random.default_rng(12)
    n, b = cfg.stylegan.n_latent, 2
    blend_b = (rng.standard_normal((b, n, 512), np.float32) * 0.3,
               rng.standard_normal((b, n, 512), np.float32) * 0.3,
               rng.standard_normal((b, 32, 32, 128), np.float32) * 0.3,
               _blocky(rng, b, 4), _blocky(rng, b, 4),
               (_blocky(rng, b, 8, 1, 0, 1) > 0.3).astype(np.float32),
               (_blocky(rng, b, 8, 1, 0, 1) > 0.5).astype(np.float32),
               (_blocky(rng, b, 8, 1, 0, 1) > 0.5).astype(np.float32))
    pose_b = (_blocky(rng, b, 8, 3, 0, 1), rng.uniform(0, 255, (b, 76, 2)).astype(np.float32),
              rng.standard_normal((b, n, 512), np.float32) * 0.5,
              rng.standard_normal((b, n, 512), np.float32) * 0.5)

    arc = w["arcface"]
    arc["bn_feat"] = {k: torch.zeros_like(v) if k in ("beta", "mean") else torch.ones_like(v)
                      for k, v in arc["bn_feat"].items()}
    with torch.no_grad():
        e = TR._arcface_embed({"arcface": arc}, torch.from_numpy(
            np.concatenate([pose_b[0], _blocky(rng, 4, 8, 3, 0, 1)])))
    arc["bn_feat"].update(mean=e.mean(0), var=e.var(0, unbiased=False) + 1e-4)

    def grid_kp(fr, img):  # 76 pixel values of a 9 x 9 grid, as coordinates
        return img[:, ::29, ::29, :2].reshape(img.shape[0], -1, 2)[:, :76] * 255.0

    def star_kp(fr, img):
        return star.keypoints_256(fr["star"], img)

    def pose_case(kp):
        return (("generator", "arcface", "star"), "rotate", pose_b,
                lambda p, fr, bt: TR.rotate_pose_loss(p, fr, bt, kp, cfg, mults),
                lambda fr: TR.make_rotate_train_steps(fr, kp, cfg, lr=lr)[::2], (mults,))

    mults = (7e-4, 1.3e-3)  # 1e-3 of (0.7, 1.3): see the docstring
    cases = {  # name: (frozen, params, batch, loss_fn, step maker, step's extra args)
        "blending step": (("generator", "clip"), "blend", blend_b,
                          lambda p, fr, bt: TB.blending_loss(p, fr, bt, cfg),
                          lambda fr: TB.make_blending_train_step(fr, cfg, lr=lr), ()),
        "rotate pose step, grid keypoints": pose_case(grid_kp),
        "rotate pose step, STAR": pose_case(star_kp)}

    def run(name, dev, dt, star_p=None, with_step=True):
        """(loss, grads, params after one Adam step) of case `name` on `dev`
        in `dt`, as float64 on the CPU."""
        frozen_keys, params_key, batch_np, loss_fn, make, extra = cases[name]
        src = w if star_p is None else dict(w, star=star_p)
        fr = map_tree({k: src[k] for k in frozen_keys}, lambda _, t: t.to(dev, dt).clone())
        p = map_tree(src[params_key], lambda _, t: t.to(dev, dt).clone())
        batch = tuple(torch.from_numpy(x).to(dev, dt) for x in batch_np)
        leaves = tensor_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(p, fr, batch)
        grads = [g.cpu().double() for g in torch.autograd.grad(loss, leaves)]
        for t in leaves:
            t.requires_grad_(False)
        if not with_step:
            return float(loss.detach()), grads, None
        step, tx = make(fr)
        p, _, _ = step(p, tx.init(p), *batch, *extra)
        return float(loss.detach()), grads, [t.detach().cpu().double() for t in tensor_leaves(p)]

    def gaps(a, b):
        """max |d loss| / |loss|, max |d grad| / max |grad|, max |d param| of a
        against b."""
        (la, ga, pa), (lb, gb, pb) = a, b
        d_grad = max(float((x - y).abs().max()) for x, y in zip(ga, gb)) / max(
            float(y.abs().max()) for y in gb)
        d_param = None if pa is None else max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        return abs(la - lb) / abs(lb), d_grad, d_param

    f32, f64 = torch.float32, torch.float64
    held = (1e-4, 1e-4, lr / 5)
    checks = {  # name: [(label, run a, run b, limits on (loss, grads, params) or None)]
        "blending step": [("card vs CPU, f32", (device, f32), ("cpu", f32), held)],
        "rotate pose step, grid keypoints": [
            ("card vs CPU, f32", (device, f32), ("cpu", f32), held)],
        "rotate pose step, STAR": [
            ("card f64 vs CPU f64", (device, f64), ("cpu", f64), held),
            ("card f32 vs CPU f64", (device, f32), ("cpu", f64),
             (1e-4, STAR_F32_GRAD_LIMIT, lr / 5)),
            ("CPU f32 vs CPU f64", ("cpu", f32), ("cpu", f64), None),
            ("card f32 vs CPU f32", (device, f32), ("cpu", f32), None)]}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name, rows in checks.items():
            res = {}
            for _, a, b, _ in rows:
                for dev, dt in (a, b):
                    if (str(dev), dt) not in res:
                        res[str(dev), dt] = run(name, dev, dt)
            for label, (da, ta), (db, tb), limits in rows:
                d = out[f"{name}: {label}"] = gaps(res[str(da), ta], res[str(db), tb])
                log(f"[train] {name} (micro, TF32 off), {label}: loss "
                    f"{res[str(db), tb][0]:.6f}, max |d loss| {d[0]:.2e} of it; max |d grad| "
                    f"{d[1]:.2e} of max |grad|; max |d param| after the Adam step {d[2]:.2e} "
                    f"(lr {lr}); " + ("not held" if limits is None else f"limits {limits}"))
                if limits is not None and any(x > lim for x, lim in zip(d, limits)):
                    raise AssertionError(f"{name}, {label}: {d} over {limits}")
        # the CPU's own f32 gap to float64 over STAR seeds: what the f32 limit rests on
        spread = {2: out["rotate pose step, STAR: CPU f32 vs CPU f64"][1]}
        for seed in (0, 1, 3, 4, 5, 6, 7):
            sp = micro_star(seed)
            spread[seed] = gaps(*(run("rotate pose step, STAR", "cpu", dt, sp, with_step=False)
                                  for dt in (f32, f64)))[1]
        out["star_f32_spread"] = spread
        log(f"[train] STAR pose step, CPU f32 vs CPU f64 max |d grad| / max |grad| by STAR "
            f"seed: {', '.join(f'{k}: {v:.2e}' for k, v in sorted(spread.items()))}; the card's "
            f"f32 run is held at {STAR_F32_GRAD_LIMIT:g}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return out


def phase_train_pp(zoo32, device, card: str, cfg=None) -> dict:
    """The PostProcess training path at full width, B=2, on phase 4's f32 zoo:
    generate_pp_sample (ms, launches, the JAX row ABI); 1 + 3 fused encoder
    steps with the discriminator (three generator renders at 1024^2, random
    full-width BiSeNet-16 / IR-SE-50 / LPIPS-AlexNet and discriminator),
    1 + 3 discriminator steps and one R1; 1 + 3 steps each in bf16, split
    and remat; one fused step under torch.profiler; micro fused and split
    steps on the card against the CPU; the train state with the
    discriminator round-tripped onto the card."""
    import shutil

    import torch

    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.params.checkpoint import restore_train_state, save_train_state
    from hairfastgan_torch.train import datagen as D
    from hairfastgan_torch.train import pp as P
    from hairfastgan_torch.train.common import tensor_leaves
    from hairfastgan_torch.zoo import cast_zoo, init_discriminator, pp_train_frozen

    out = {}
    cfg = cfg or HairFastConfig()
    size = cfg.stylegan.size
    rng = np.random.default_rng(6)
    face, shape, color = (torch.from_numpy(rng.random((2, size, size, 3), np.float32)).to(device)
                          for _ in range(3))
    gen = lambda: D.generate_pp_sample(zoo32, face, shape, color, cfg)  # noqa: E731
    row = counted("datagen generate_pp_sample", gen)
    ms = [counted("datagen generate_pp_sample", lambda: _event_ms(gen))[1] for _ in range(3)]
    n = LAUNCHES["datagen generate_pp_sample"]
    if n != 2:  # align_images' soft masks and the blend masks: one [3b] launch each
        raise AssertionError(f"generate_pp_sample: {n} dilate_erode launches per call")
    abi = {"source": (2, 256, 256, 3), "target": (2, 256, 256, 3),
           "target_mask": (2, 256, 256, 1), "HT_E": (2, 256, 256, 1),
           "source_full": (2, size, size, 3)}
    got = {k: tuple(v.shape) for k, v in row.items()}
    bad = [k for k, v in row.items() if v.dtype != torch.float32 or not torch.isfinite(v).all()]
    if got != abi or bad:
        raise AssertionError(f"generate_pp_sample rows {got} (non-finite or not f32: {bad})")
    out["generate_pp_sample"] = (statistics.median(ms), n)
    log(f"[train_pp] generate_pp_sample B=2 f32: p50 {out['generate_pp_sample'][0]:.2f} ms "
        f"(CUDA events, 3 calls after one), dilate_erode launches per call {n}; rows of the "
        f"JAX row ABI, finite f32: {abi}  [{card}]")

    frozen = pp_train_frozen(zoo32["generator"], 1.0, seed=2, device=device)
    params = map_tree(zoo32["post_process"], lambda _, t: t.clone())
    disc = init_discriminator(cfg.stylegan, seed=3, device=device)
    batch = tuple(row[k] for k in ("source", "target", "target_mask", "HT_E"))
    real = row["source_full"]
    snapshot = [t.clone() for t in tensor_leaves(frozen)]
    before = [t.clone() for t in tensor_leaves(params)]
    d_before = [t.clone() for t in tensor_leaves(disc)]
    enc, dstep, r1_step, tx, d_tx = P.make_pp_train_steps(frozen, cfg=cfg, use_adv=True)
    opt, d_opt = tx.init(params), d_tx.init(disc)
    last = {}

    def enc_step(step, o, *extra):
        aux = step(params, o, *batch, *extra, 0.5)[2]
        last["gen_f"] = aux["gen_f"]
        return aux

    def disc_step():
        return dstep(disc, d_opt, real, last["gen_f"])[2]

    p50, peak, resident, auxs = _timed_steps("train_pp fused", [
        ("enc", lambda: enc_step(enc, opt, disc)) for _ in range(4)], device)
    dp50, dpeak, _, dauxs = _timed_steps("train_pp disc", [
        ("disc", disc_step) for _ in range(4)], device)
    r1, r1_ms = _event_ms(lambda: r1_step(disc, real))
    if not (torch.isfinite(r1) and r1 > 0):
        raise AssertionError(f"R1 {r1}")
    _check_frozen("train_pp", frozen, snapshot, params, before)
    d_moved = sum(not torch.equal(a, b) for a, b in zip(tensor_leaves(disc), d_before))
    if d_moved != len(d_before):
        raise AssertionError(f"disc steps moved {d_moved}/{len(d_before)} leaves")
    terms = {k: round(float(v), 5) for k, v in auxs[-1].items() if v.ndim == 0}
    out["fused"] = (p50["enc"], peak, resident)
    out["disc"] = (dp50["disc"], dpeak)
    out["r1_ms"] = r1_ms
    log(f"[train_pp] fused encoder step with the discriminator, B=2 f32 at {size}^2: p50 "
        f"{p50['enc']:.2f} ms (CUDA events, the 3 after the first); peak memory {peak:.2f} GiB, "
        f"of which {resident:.2f} GiB resident before; last step's terms {terms}; the post-"
        f"process encoder moved, generator, BiSeNet-16, IR-SE-50 and LPIPS untouched with no "
        f".grad  [{card}]")
    log(f"[train_pp] discriminator step B=2 at {size}^2: p50 {dp50['disc']:.2f} ms, peak "
        f"{dpeak:.2f} GiB, losses {[round(float(a['disc_adv']), 5) for a in dauxs]}; all "
        f"{d_moved} leaves moved; R1 {float(r1):.4e} in {r1_ms:.2f} ms  [{card}]")

    frozen16 = cast_zoo(frozen, torch.bfloat16)  # resident in bf16, as train_pp --bf16
    variants = {
        "bf16": P.make_pp_train_steps(frozen16, cfg=cfg, use_adv=True,
                                      compute_dtype=torch.bfloat16)[::3],
        "split": P.make_pp_split_train_step(frozen, cfg=cfg, use_adv=True),
        "remat": P.make_pp_train_steps(frozen, cfg=cfg, use_adv=True, remat=True)[::3]}
    for name, (step, vtx) in variants.items():
        vopt = vtx.init(params)
        vp50, vpeak, vres, vauxs = _timed_steps(f"train_pp {name}", [
            (name, lambda: enc_step(step, vopt, disc)) for _ in range(4)], device)
        out[name] = (vp50[name], vpeak, vres)
        log(f"[train_pp] {name} encoder step with the discriminator, B=2 at {size}^2: p50 "
            f"{vp50[name]:.2f} ms, peak {vpeak:.2f} GiB over {vres:.2f} GiB resident; losses "
            f"{[round(float(a['loss']), 5) for a in vauxs]}  [{card}]")
        del vopt
    del frozen16

    n_ev, busy = _profiled_step(lambda: enc_step(enc, opt, disc))
    out["profile"] = (n_ev, busy, p50["enc"])
    log(f"[train_pp] fused step under torch.profiler: {n_ev} device events, {busy:.2f} ms "
        f"device busy of the {p50['enc']:.2f} ms step p50 (busy share {busy / p50['enc']:.3f})"
        f"  [{card}]")

    tmp = tempfile.mkdtemp(prefix="train_state_pp_")
    try:
        sd = opt.state_dict()
        save_train_state(Path(tmp) / "last", params, sd, 4, disc_params=disc)
        state = restore_train_state(Path(tmp) / "last", device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(a, b) and a.device == b.device for name, tree in
               (("params", params), ("disc", disc))
               for a, b in zip(tensor_leaves(state[name]), tensor_leaves(tree)))
    if not (same and state["step"] == 4):
        raise AssertionError("the restored PP train state differs from the saved one")
    log(f"[train_pp] train state with the discriminator: saved and restored onto {device}, "
        f"{len(tensor_leaves(params))} params and {len(tensor_leaves(disc))} disc leaves equal")
    del opt, d_opt, params, disc, snapshot, before, d_before, last, state
    torch.cuda.empty_cache()

    out["card_vs_cpu"] = _pp_card_vs_cpu(device)
    return out


def _pp_card_vs_cpu(device) -> dict:
    """A fused and a split PostProcess step with the discriminator at a micro
    config (128^2 generator at 32 channels, BiSeNet-16 and IR-SE-50 at width
    0.25, LPIPS-AlexNet), the same weights and inputs on the card and the
    CPU, TF32 off, in f32 and in float64: max |d loss| / |loss|, max |d grad|
    / max |grad| (limit 1e-4 each), max |d param| after the Adam step (limit
    lr/5). As in tests/test_torch_port_pp_train.py, IR-SE's embeddings are
    centred and scaled to norm ~1, LPIPS' linear weights are non-negative,
    and the steps run at 1e-3 of the loss weights (Adam's first step stays
    linear in g).

    The images carry per-pixel noise and the masks are soft (no two pixels
    equal): on flat regions (blocky images, binary masks) the max-pools of
    LPIPS and BiSeNet see tied windows, which the card and the CPU may break
    at different positions (with such inputs the card's f32 gradient was
    5.78e-4 of max|grad| off the CPU's, against 1.09e-5 between f32 and
    float64 on the CPU)."""
    import torch

    from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
    from hairfastgan_torch.losses.identity import extract_id_feats
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.train import pp as P
    from hairfastgan_torch.train.common import tensor_leaves
    from hairfastgan_torch.zoo import (fill_random, init_discriminator, micro_zoo_shapes,
                                       pp_train_frozen)

    lr = 1e-3
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=128, max_channels=32))
    shapes, _ = micro_zoo_shapes(max_channels=32)
    w = _lively(fill_random({"generator": shapes["generator"],
                             "post_process": shapes["post_process"]}, 4))
    frozen = pp_train_frozen(w["generator"], 0.25, seed=5)
    for k in ("bisenet16", "id_backbone"):
        _lively(frozen[k])
    disc = init_discriminator(cfg.stylegan, seed=6)
    for lin in frozen["lpips"]["lins"]:
        lin["w"].abs_()
    rng = np.random.default_rng(14)

    def noisy(x, lo, hi):
        return np.clip(x + rng.normal(0, 0.05, x.shape), lo, hi).astype(np.float32)

    batch_np = (noisy(_blocky(rng, 2, 8), -1, 1), noisy(_blocky(rng, 2, 8), -1, 1),
                noisy(_blocky(rng, 2, 8, 1, 0.1, 0.9), 0, 1),
                noisy(_blocky(rng, 2, 16, 1, 0.1, 0.9), 0, 1))
    bn = frozen["id_backbone"]["bn_feat"]
    with torch.no_grad():
        e = extract_id_feats(frozen["id_backbone"], torch.from_numpy(
            np.concatenate([batch_np[0] * batch_np[2], batch_np[1]])))
        m = e.mean(0)
        s = (e - m).norm(dim=1).mean()
        bn["gamma"].div_(s)
        bn["beta"].sub_(m).div_(s)
    weights = {k: v * 1e-3 for k, v in P.DEFAULT_WEIGHTS.items()}

    def run(dev, dt, split):
        fr, p, d = (map_tree(t, lambda _, v: v.to(dev, dt).clone())
                    for t in (frozen, w["post_process"], disc))
        batch = tuple(torch.from_numpy(x).to(dev, dt) for x in batch_np)
        leaves = tensor_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = P.pp_loss(p, fr, batch, weights, 0.7, d, cfg)
        grads = [g.cpu().double() for g in torch.autograd.grad(loss, leaves)]
        for t in leaves:
            t.requires_grad_(False)
        if split:
            step, tx = P.make_pp_split_train_step(fr, weights, cfg, lr=lr, use_adv=True)
        else:
            step, _, _, tx, _ = P.make_pp_train_steps(fr, weights, cfg, lr=lr, use_adv=True)
        p, _, aux = step(p, tx.init(p), *batch, d, 0.7)
        return (float(aux["loss"]), grads, [t.detach().cpu().double() for t in tensor_leaves(p)])

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    held = (1e-4, 1e-4, lr / 5)
    try:
        for split in (False, True):
            for dt in (torch.float64, torch.float32):
                (la, ga, pa), (lb, gb, pb) = run(device, dt, split), run("cpu", dt, split)
                d = (abs(la - lb) / abs(lb),
                     max(float((x - y).abs().max()) for x, y in zip(ga, gb))
                     / max(float(y.abs().max()) for y in gb),
                     max(float((x - y).abs().max()) for x, y in zip(pa, pb)))
                name = f"{'split' if split else 'fused'} step, {str(dt).split('.')[-1]}"
                out[name] = d
                log(f"[train_pp] {name} (micro, with the discriminator, TF32 off), card vs "
                    f"CPU: loss {lb:.6f}, max |d loss| {d[0]:.2e} of it; max |d grad| "
                    f"{d[1]:.2e} of max |grad|; max |d param| after the Adam step {d[2]:.2e} "
                    f"(lr {lr}); limits {held}")
                if any(x > lim for x, lim in zip(d, held)):
                    raise AssertionError(f"PP {name}, card vs CPU: {d} over {held}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return out


def run_module(module: str, argv, key: str, prelude: str = "", timeout: int = 600):
    """`python -m <module> argv` in a subprocess (after the Python lines
    `prelude`) that records the kernel's launches under LAUNCHES[key] and
    its shapes in SEEN; returns the subprocess's stdout."""
    code = "\n".join([
        "import json, runpy, sys; import chip_smoke as C",
        "from hairfastgan_torch.ops import morphology as M; C.record_shapes()", prelude,
        f"sys.argv = {[module] + list(argv)!r}",
        f"runpy.run_module({module!r}, run_name='__main__')",
        "print('SHAPES', json.dumps(sorted(C.SEEN))); print('LAUNCHES', M.dilate_erode.launches)"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=timeout, cwd=Path(__file__).resolve().parent)
    if res.returncode != 0:
        raise AssertionError(f"{module} failed ({res.returncode}): {res.stderr[-3000:]}")
    shapes, n = res.stdout.split("SHAPES")[-1].split("LAUNCHES")
    SEEN.update((tuple(s), t, i) for s, t, i in json.loads(shapes))
    LAUNCHES[key] = int(n)
    return res.stdout


def phase_cli(card: str) -> None:
    """python -m hairfastgan_torch.main --micro --poisson on the card, in a
    subprocess that reports the kernel's launches."""
    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(11)
        for name in "abc":
            Image.fromarray(rng.integers(0, 256, (200, 160, 3), dtype=np.uint8)).save(
                Path(d) / f"{name}.png")
        argv = ["--micro", "--poisson", "--input_dir", d, "--face_path", "a.png",
                "--shape_path", "b.png", "--color_path", "c.png",
                "--output_dir", str(Path(d) / "out")]
        run_module("hairfastgan_torch.main", argv, "CLI --micro --poisson")
        n = LAUNCHES["CLI --micro --poisson"]
        shape = np.asarray(Image.open(Path(d) / "out" / "a_b_c.png")).shape
    log(f"[cli] --micro --poisson on the card: wrote a_b_c.png {shape}; dilate_erode launches "
        f"{n}  [{card}]")
    if n < 3 or shape != (128, 128, 3):
        raise AssertionError(f"CLI: {n} launches, {shape}")
    phase_train_cli(card)


def phase_train_cli(card: str) -> None:
    """The six training scripts with --device cuda in one subprocess:
    gen_blending_data --tiny (4 triples) -> train_blending --tiny,
    gen_rotate_data --tiny --no_keypoints (4 pairs) -> train_rotate --tiny
    --no_keypoints, 1 epoch each at batch 2, and gen_pp_data --tiny (4
    triples) -> train_pp --tiny --use_adv (1 epoch at batch 1, FID-CLIP
    against the images, a grid); best/last train states must exist and
    train_pp's log hold disc_adv, r1 and fid_clip. Reports the kernel's
    launches and shapes."""
    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        rng = np.random.default_rng(13)
        (d / "imgs").mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (200, 160, 3), dtype=np.uint8)).save(
                d / "imgs" / f"{i}.png")
        common = ["--device", "cuda", "--zoo_dir", str(d / "nozoo")]
        train = ["--tiny", "--epochs", "1", "--batch_size", "2", "--test_frac", "0.5"]
        runs = [
            ("gen_blending_data", ["--tiny", "--input_dir", str(d / "imgs"), "--n_random", "4",
                                   "--out_dir", str(d / "blend")]),
            ("train_blending", train + ["--data_dir", str(d / "blend"), "--ckpt_dir",
                                        str(d / "ckpt_b"), "--log", str(d / "b.jsonl")]),
            ("gen_rotate_data", ["--tiny", "--no_keypoints", "--input_dir", str(d / "imgs"),
                                 "--n_pairs", "4", "--pose_dir", str(d / "pose"),
                                 "--hair_dir", str(d / "hair")]),
            ("train_rotate", train + ["--no_keypoints", "--pose_dir", str(d / "pose"),
                                      "--hair_dir", str(d / "hair"), "--ckpt_dir",
                                      str(d / "ckpt_r"), "--log", str(d / "r.jsonl")]),
            ("gen_pp_data", ["--tiny", "--input_dir", str(d / "imgs"), "--n_random", "4",
                             "--out_dir", str(d / "pp")]),
            # batch 1: two train rows, so the second step is past --iter_before
            ("train_pp", ["--tiny", "--epochs", "1", "--batch_size", "1", "--test_frac", "0.5",
                          "--use_adv", "--iter_before", "1", "--d_reg_every", "1",
                          "--torch_dir", str(d / "no_torch"), "--fid_real_dir", str(d / "imgs"),
                          "--grid_dir", str(d / "grids"), "--data_dir", str(d / "pp"),
                          "--ckpt_dir", str(d / "ckpt_p"), "--log", str(d / "p.jsonl")])]
        code = ["import json, runpy, sys, time; import chip_smoke as C",
                "from hairfastgan_torch.ops import morphology as M; C.record_shapes()"]
        for mod, argv in runs:
            full = [mod] + argv + common
            code += [f"t0 = time.perf_counter(); M.dilate_erode.launches = 0; sys.argv = {full!r}",
                     f"runpy.run_module('hairfastgan_torch.scripts.{mod}', run_name='__main__')",
                     f"print('RAN', {mod!r}, M.dilate_erode.launches, "
                     "round(time.perf_counter() - t0, 2))"]
        code.append("print('SHAPES', json.dumps(sorted(C.SEEN)))")
        res = subprocess.run([sys.executable, "-c", "\n".join(code)], capture_output=True,
                             text=True, timeout=600, cwd=Path(__file__).resolve().parent)
        if res.returncode != 0:
            raise AssertionError(f"training CLIs failed ({res.returncode}): {res.stderr[-3000:]}")
        ran = [line.split()[1:] for line in res.stdout.splitlines() if line.startswith("RAN")]
        SEEN.update((tuple(s), t, i) for s, t, i in json.loads(
            res.stdout.split("SHAPES")[-1]))
        states = sorted(str(p.relative_to(d)) for p in d.glob("ckpt_*/*/train_state.pt"))
        n_rows = tuple(len(list((d / k).glob("*.npz"))) for k in ("blend", "pose", "pp"))
        pp_log = [json.loads(line) for line in (d / "p.jsonl").read_text().splitlines()]
        pp_keys = sorted({k for rec in pp_log for k in rec} & {"disc_adv", "r1", "fid_clip",
                                                                "val_loss"})
        grids = len(list((d / "grids").glob("epoch_*.png")))
    for mod, n, s in ran:
        LAUNCHES[f"CLI {mod} --tiny"] = int(n)
    random_d = "RANDOM discriminator" in res.stdout
    log(f"[cli] training scripts --tiny --device cuda (module, dilate_erode launches, seconds): "
        f"{ran}; rows {n_rows}; train states {states}; train_pp logged {pp_keys}, {grids} "
        f"grid, random-discriminator warning printed: {random_d}  [{card}]")
    # gen_blending_data / gen_pp_data: align_images' and the blend masks' launch per row
    if (len(ran) != 6 or n_rows != (4, 4, 4) or len(states) != 6 or int(ran[0][1]) != 8
            or int(ran[4][1]) != 8 or pp_keys != ["disc_adv", "fid_clip", "r1", "val_loss"]
            or grids != 1 or not random_d):
        raise AssertionError(f"training CLIs: ran {ran}, rows {n_rows}, states {states}, "
                             f"train_pp logged {pp_keys}, grids {grids}")


# -- phase 14: evaluation and offline tools -----------------------------------

def write_golden(d: Path, final, inter) -> None:
    """One run's numpy intermediates (hair_fast's keys and layouts, F tensors
    NHWC) and final image, in the reference's save_all layout (torch NCHW
    latents, vis-mask PNGs, final.png): the golden the parity harness reads."""
    from PIL import Image

    from hairfastgan_torch.utils.save_utils import save_vis_mask

    def to_torch_f(f):  # NHWC [1,H,W,C] -> [1,C,H,W]
        return np.transpose(f, (0, 3, 1, 2))

    d = Path(d)
    for name in ("face", "shape", "color"):
        (d / "W+").mkdir(parents=True, exist_ok=True)
        (d / "FS").mkdir(exist_ok=True)
        np.savez(d / "W+" / f"{name}.npz", latent_W=inter[f"W_{name}"])
        np.savez(d / "FS" / f"{name}.npz", latent_S=inter[f"S_{name}"],
                 latent_F=to_torch_f(inter[f"F_{name}"]))
        save_vis_mask(d, "Shape", f"mask_{name}.png", inter[f"mask_{name}"][0])
    (d / "Align").mkdir(exist_ok=True)
    np.savez(d / "Align" / "face_shape_F.npz", latent_F_align=to_torch_f(inter["latent_F_align"]))
    (d / "Blending").mkdir(exist_ok=True)
    np.savez(d / "Blending" / "blending.npz", S_blend=inter["S_blend"])
    (d / "Final").mkdir(exist_ok=True)
    np.savez(d / "Final" / "final.npz", S_final=inter["S_final"],
             F_final=to_torch_f(inter["F_final"]))
    arr = (np.clip(final[0], 0, 1) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(d / "Final" / "final.png")


def inception_state_dict(params) -> dict:
    """The port's InceptionV3 params -> a torchvision inception_v3 state dict
    (CPU tensors): the inverse of models/inception.convert_inception."""
    from hairfastgan_torch.models.inception import BRANCH_MAP, TV_MAP

    sd = {}

    def emit(tv, cbn):
        bn = cbn["bn"]
        sd.update({f"{tv}.conv.weight": cbn["conv"]["w"], f"{tv}.bn.weight": bn["gamma"],
                   f"{tv}.bn.bias": bn["beta"], f"{tv}.bn.running_mean": bn["mean"],
                   f"{tv}.bn.running_var": bn["var"]})

    for ours, tv in TV_MAP.items():
        if ours.startswith("stem."):
            emit(tv, params["stem"][ours.split(".")[1]])
        else:
            for k, v in BRANCH_MAP[ours[0]].items():
                emit(f"{tv}.{v}", params[ours][k])
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def star_state_dict(p) -> dict:
    """The port's STAR params -> the reference's star_wflw.pth layout
    ({"net": state dict}, CPU tensors): the inverse of models/star.convert_star."""
    sd = {}

    def conv(name, c):
        sd[f"{name}.weight"] = c["w"]
        if "b" in c:
            sd[f"{name}.bias"] = c["b"]

    def bn(name, b):
        sd.update({f"{name}.weight": b["gamma"], f"{name}.bias": b["beta"],
                   f"{name}.running_mean": b["mean"], f"{name}.running_var": b["var"]})

    def cb(name, c):
        conv(f"{name}.conv", c["conv"])
        if "bn" in c:
            bn(f"{name}.bn", c["bn"])

    def rb(name, r):
        for i in (1, 2, 3):
            bn(f"{name}.bn{i}", r[f"bn{i}"])
            cb(f"{name}.conv{i}", r[f"conv{i}"])
        if "skip" in r:
            cb(f"{name}.skip_layer", r["skip"])

    def hg(name, h):
        for part in ("up1", "low1", "low3"):
            rb(f"{name}.{part}", h[part])
        (hg if "low2" in h["low2"] else rb)(f"{name}.low2", h["low2"])
        if "coordconv" in h:
            conv(f"{name}.coordconv.conv", h["coordconv"]["conv"])

    cb("pre.0", p["pre_conv"])
    for i, key in ((1, "pre_r1"), (3, "pre_r2"), (4, "pre_r3")):
        rb(f"pre.{i}", p[key])
    for i, st in enumerate(p["stacks"]):
        hg(f"hgs.{i}", st["hg"])
        rb(f"features.{i}.0", st["feat_r"])
        cb(f"features.{i}.1", st["feat_c"])
        for ours, ref in (("out_heat", "out_heatmaps"), ("out_point", "out_pointmaps"),
                          ("out_edge", "out_edgemaps"), ("merge_feat", "merge_features"),
                          ("merge_heat", "merge_heatmaps"), ("merge_point", "merge_pointmaps"),
                          ("merge_edge", "merge_edgemaps")):
            if ours in st:
                cb(f"{ref}.{i}", st[ours])
    return {"net": {k: v.detach().cpu().contiguous() for k, v in sd.items()}}


def _eval_upload_res(device, card: str) -> dict:
    """The codec-free resize library loads and its 1024 -> 512 resize is
    within 1 uint8 step of the device's bicubic; then upload_res_agreement
    at --n 8 on the card, Keys beside LANCZOS, hair_iou defined for both."""
    import torch

    from hairfastgan_torch.data import native_loader
    from hairfastgan_torch.ops.resample import resize
    from hairfastgan_torch.scripts import upload_res_agreement

    if not native_loader.resize_available():
        raise AssertionError(f"the resize-only library did not load: "
                             f"{native_loader.resize_error()}")
    img = np.random.default_rng(41).integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    host = native_loader.resize_u8_native(img, 512)
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(img).to(device).permute(2, 0, 1)[None].float() / 255.0
    dev = (resize(x, (512, 512), "bicubic").clamp(0, 1) * 255.0 + 0.5).floor()
    dev = dev[0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()
    step = int(np.abs(host.astype(np.int16) - dev.astype(np.int16)).max())
    log(f"[eval] resize-only library (csrc/resize_u8.cpp) loaded; the full loader "
        f"{'built' if native_loader.native_available() else 'did not build'} "
        f"({native_loader.native_error()}); 1024->512 Keys bicubic on the host vs the card's "
        f"bicubic: max |diff| {step} uint8 step(s)  [{card}]")
    if step > 1:
        raise AssertionError(f"host Keys resize is {step} steps from the device bicubic")
    agree = counted("upload_res_agreement", lambda: upload_res_agreement.main(
        ["--n", "8", "--device", "cuda"]), at_least=0)
    log(f"[eval] upload_res_agreement --n 8 --upload_res 512 on the card: Keys "
        f"{agree['keys']}; LANCZOS {agree['lanczos']}  [{card}]")
    log(f"[eval] hair_iou: Keys {agree['keys']['hair_iou']}, LANCZOS "
        f"{agree['lanczos']['hair_iou']}  [{card}]")
    if any(agree[r]["hair_iou"] is None for r in ("keys", "lanczos")):
        raise AssertionError("upload_res_agreement's BiSeNet gave no hair pixel: hair_iou "
                             "is undefined")
    return {"resize_step": step, "upload_res": agree}


def _eval_inception(device, card: str) -> float:
    """Full-width InceptionV3 (init_inception, seed 0) on 16 seeded 1024^2
    images: the card's f32 features against the CPU's, and the p50 ms per
    batch of 16 by CUDA events."""
    import torch

    from hairfastgan_torch.models.inception import init_inception, inception_features_nchw
    from hairfastgan_torch.params.bridge import map_tree

    params = init_inception(0, device)
    x = torch.from_numpy(np.random.default_rng(42).random((16, 3, 1024, 1024), dtype=np.float32))
    xd = x.to(device)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        card_f = inception_features_nchw(params, xd).cpu()
        cpu_f = inception_features_nchw(map_tree(params, lambda _, t: t.cpu()), x)
    torch.backends.cudnn.allow_tf32 = True
    err = (card_f - cpu_f).abs().max().item() / cpu_f.abs().max().item()
    with torch.inference_mode():
        for _ in range(2):
            inception_features_nchw(params, xd)
        times = [_event_ms(lambda: inception_features_nchw(params, xd))[1]
                 for _ in range(10)]
    p50 = statistics.median(times)
    log(f"[eval] InceptionV3 pool3 [16,2048] from 16 x 1024^2: card vs CPU (f32, TF32 off) "
        f"max |diff| {err:.2e} of max |feature| {cpu_f.abs().max().item():.4f}; p50 "
        f"{p50:.2f} ms per batch of 16 (CUDA events, 10 runs, TF32 as PyTorch defaults; "
        f"min {min(times):.2f}, max {max(times):.2f})  [{card}]")
    if not torch.isfinite(card_f).all() or err > 1e-3:
        raise AssertionError(f"Inception card vs CPU: {err}")
    return p50


def _eval_fid_metric(device, card: str) -> None:
    """fid_metric with --device cuda in a subprocess on a real and two method
    directories of 16 seeded PNGs, with a random torchvision-layout
    --inception_ckpt: its CSV against frechet_distance in this process."""
    import torch
    from PIL import Image

    from hairfastgan_torch.eval.fid import FIDStats, clip_feature_fn, frechet_distance
    from hairfastgan_torch.models.inception import init_inception
    from hairfastgan_torch.scripts import fid_metric

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        rng = np.random.default_rng(43)
        for sub in ("real", "m1", "m2"):
            (d / sub).mkdir()
            for i in range(16):
                Image.fromarray(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)).save(
                    d / sub / f"{i:02d}.png")
        ckpt = d / "inception_v3.pth"
        torch.save(inception_state_dict(init_inception(1)), ckpt)
        argv = ["--real_dir", str(d / "real"), "--method_dirs", str(d / "m1"), str(d / "m2"),
                "--inception_ckpt", str(ckpt), "--zoo_dir", str(d / "nozoo"), "--batch", "8",
                "--fid_cache", str(d / "cache" / "real.npz"), "--out_csv", str(d / "fid.csv"),
                "--device", "cuda"]
        t0 = time.perf_counter()
        run_module("hairfastgan_torch.scripts.fid_metric", argv, "fid_metric")
        run_s = time.perf_counter() - t0
        lines = (d / "fid.csv").read_text().splitlines()
        caches = sorted(p.name for p in (d / "cache").iterdir())
        feats = {"fid": fid_metric.load_inception_feature_fn(ckpt, device),
                 "fid_clip": clip_feature_fn(fid_metric.clip_tower(d / "nozoo", device))}
        ref = {}
        for name, fn in feats.items():
            real = fid_metric.real_stats(d / "real", fn, batch=8)
            for m in ("m1", "m2"):
                fake = fid_metric.load_dir(d / m)
                sf = FIDStats()
                for i in range(0, len(fake), 8):
                    sf.update(fn(fake[i:i + 8]))
                ref[m, name] = frechet_distance(*real, *sf.finalize())
    rows = {r.split(",")[0]: [float(v) for v in r.split(",")[1:]] for r in lines[1:]}
    log(f"[eval] fid_metric --device cuda (subprocess, {run_s:.1f} s): {lines}; in-process "
        f"frechet_distance {ref}; caches {caches}  [{card}]")
    if lines[0] != "method,fid,fid_clip" or sorted(rows) != ["m1", "m2"]:
        raise AssertionError(f"fid_metric CSV: {lines}")
    if caches != ["real_fid.npz", "real_fid_clip.npz"]:
        raise AssertionError(f"fid_metric caches: {caches}")
    for m, vals in rows.items():
        for v, name in zip(vals, ("fid", "fid_clip")):
            r = ref[m, name]
            if not (np.isfinite(v) and abs(v - r) <= 1e-6 + 1e-4 * abs(r)):
                raise AssertionError(f"fid_metric {m} {name}: CSV {v} vs in-process {r}")


def mapping_init(seed: int, cfg, device) -> dict:
    """The generator's mapping network (params["style"]) with its init law,
    EqualLinear weights N(0,1) / lr_mul and zero biases, from a numpy seed:
    the zoo's flat 0.05 fill collapses P space onto the biases."""
    import torch

    rng = np.random.default_rng(seed)
    return {"style": [{"w": torch.from_numpy(rng.standard_normal(
        (cfg.style_dim, cfg.style_dim), dtype=np.float32) / np.float32(cfg.lr_mlp)).to(device),
        "b": torch.zeros(cfg.style_dim, device=device)} for _ in range(cfg.n_mlp)]}


def _eval_pspace(device, card: str) -> float:
    """build_pca_model on the full-width mapping network on the card
    (100,000 samples in batches of 10,000): X_comp orthonormal to 1e-4, and
    p_norm_loss on the card within 1e-4 of the CPU's on the same dict."""
    import torch

    from hairfastgan_torch import pspace
    from hairfastgan_torch.config import StyleGANConfig
    from hairfastgan_torch.models import stylegan2

    cfg = StyleGANConfig()
    gen = mapping_init(5, cfg, device)
    t0 = time.perf_counter()
    model = counted("pspace.build_pca_model", lambda: pspace.build_pca_model(
        gen, None, n_samples=100_000, batch=10_000, cfg=cfg), at_least=0)
    build_s = time.perf_counter() - t0
    comp = model["X_comp"].astype(np.float64)
    ortho = float(np.abs(comp @ comp.T - np.eye(cfg.style_dim)).max())
    pca = {k: torch.from_numpy(model[k]) for k in pspace.PCA_KEYS}
    z = torch.randn((4, cfg.style_dim), generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    with torch.no_grad():
        lat = stylegan2.latent_to_wplus(stylegan2.mapping(gen, z, cfg), cfg.n_latent)
        card_l = pspace.p_norm_loss({k: v.to(device) for k, v in pca.items()}, lat).item()
        cpu_l = pspace.p_norm_loss(pca, lat.cpu()).item()
    rel = abs(card_l - cpu_l) / abs(cpu_l)
    log(f"[eval] build_pca_model (100,000 samples, batch 10,000, mapping on the card, float64 "
        f"eigh on the host): {build_s:.2f} s; |X_comp X_comp^T - I| max {ortho:.2e}; stdev "
        f"{model['X_stdev'][0]:.4f} .. {model['X_stdev'][-1]:.4f}; p_norm_loss card "
        f"{card_l:.6f} vs CPU {cpu_l:.6f} (rel {rel:.2e})  [{card}]")
    if ortho > 1e-4 or not np.isfinite(card_l) or rel > 1e-4:
        raise AssertionError(f"P-space: orthonormality {ortho}, p_norm_loss {card_l} vs {cpu_l}")
    return build_s


def _eval_align_faces(card: str) -> None:
    """align_faces with --device cuda in a subprocess on three seeded
    1500x1200 photos and a random full-width STAR star_wflw.pth in the
    reference layout. Random weights give diffuse heatmaps, so the STAR gate
    is switched off in the subprocess (as phase 12 does)."""
    import torch
    from PIL import Image

    from hairfastgan_torch.zoo import init_star

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "photos").mkdir()
        (d / "zoo").mkdir()
        rng = np.random.default_rng(44)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (1500, 1200, 3), dtype=np.uint8)).save(
                d / "photos" / f"p{i}.png")
        torch.save(star_state_dict(init_star(seed=2)), d / "zoo" / "star_wflw.pth")
        gate_off = ("from hairfastgan_torch.utils import face_align as FA; "
                    "orig = FA.star_landmark_provider; "
                    "FA.star_landmark_provider = lambda p, **kw: orig(p, **dict(kw, check=False))")
        t0 = time.perf_counter()
        out = run_module("hairfastgan_torch.scripts.align_faces",
                         ["--input_dir", str(d / "photos"), "--output_dir", str(d / "out"),
                          "--zoo_dir", str(d / "zoo"), "--device", "cuda"], "align_faces",
                         prelude=gate_off)
        run_s = time.perf_counter() - t0
        shapes = [np.asarray(Image.open(p)).shape for p in sorted((d / "out").glob("*.png"))]
    log(f"[eval] align_faces --device cuda (subprocess, {run_s:.1f} s; "
        f"'{out.splitlines()[0]}'): {shapes}  [{card}]")
    if shapes != [(1024, 1024, 3)] * 3 or "STAR (on cuda)" not in out:
        raise AssertionError(f"align_faces wrote {shapes}: {out[-500:]}")


def _eval_parity_harness(zoo32, device, card: str) -> None:
    """A golden in the reference's layout from the port's own f32 zero-noise
    run on the card, at full width; the harness (--device cuda, the zoo
    through a zoo_torch.pt) must pass it, and fail once Align/face_shape_F
    is scaled by 1.1."""
    import contextlib
    import io

    import torch
    from PIL import Image

    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.params.checkpoint import save_zoo
    from hairfastgan_torch.scripts import parity_harness as H
    from hairfastgan_torch.utils.images import to_image_array

    cfg = HairFastConfig()
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        rng = np.random.default_rng(45)
        paths = [d / f"{name}.png" for name in ("face", "shape", "color")]
        for p in paths:
            Image.fromarray(rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)).save(p)
        save_zoo(d / "zoo", zoo32)
        imgs = [torch.from_numpy(to_image_array(p, 1024))[None].to(device) for p in paths]
        final, inter = counted("parity_harness golden", lambda: H.run_pipeline(zoo32, imgs, cfg),
                               at_least=2)
        write_golden(d / "golden", final, inter)
        argv = ["--golden_dir", str(d / "golden"), "--face", str(paths[0]), "--shape",
                str(paths[1]), "--color", str(paths[2]), "--zoo_dir", str(d / "zoo"),
                "--device", "cuda"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counted("parity_harness", lambda: H.main(argv), at_least=2)
        run_s = time.perf_counter() - t0
        passed = buf.getvalue()
        az = d / "golden" / "Align" / "face_shape_F.npz"
        with np.load(az) as z:
            np.savez(az, latent_F_align=z["latent_F_align"] * 1.1)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                H.main(argv)
        except SystemExit as e:
            failed = str(e.code)
        else:
            raise AssertionError("the harness passed a golden with F_align scaled by 1.1")
    log(f"[eval] parity harness --device cuda at full width ({run_s:.1f} s with the zoo's load): "
        f"{passed.strip().splitlines()[-1]!r}; {len(passed.splitlines()) - 1} checks; "
        f"dilate_erode launches {LAUNCHES['parity_harness']}; F_align x1.1: exit {failed!r}  "
        f"[{card}]")
    if "all stages within tolerance" not in passed or "[FAIL]" in passed:
        raise AssertionError(f"the harness failed its own golden: {passed[-2000:]}")
    if "zero:latent_F_align" not in failed:
        raise AssertionError(f"the perturbed golden failed otherwise: {failed}")


def phase_eval(zoo32, device, card: str) -> dict:
    """The evaluation and offline tools on the card: the upload_res resize,
    InceptionV3, fid_metric, P-space, align_faces and the parity harness."""
    out = _eval_upload_res(device, card)
    out["inception_p50_ms"] = _eval_inception(device, card)
    _eval_fid_metric(device, card)
    out["pca_build_s"] = _eval_pspace(device, card)
    _eval_align_faces(card)
    _eval_parity_harness(zoo32, device, card)
    return out


def _centered_clip(clip, crops):
    """The CLIP tower with ln_post's beta set so that the embeddings of
    `crops` (NHWC [-1,1]) average to zero: a random tower embeds every image
    along nearly one direction, so 1 - cos losses would sit at the f32 noise
    floor; centred, they are O(1)."""
    import torch

    from hairfastgan_torch.models import encoders

    c = dict(clip, ln_post=dict(clip["ln_post"], beta=torch.zeros_like(clip["ln_post"]["beta"])))
    with torch.no_grad():
        e0 = encoders.clip_image_embed(c, crops)
        c["ln_post"]["beta"] = -(e0.mean(0) @ torch.linalg.pinv(c["proj"]))
    return c


def _loss_grads(params, fn, *args):
    """(loss, [gradient per leaf]) of fn(params, *args) by one backward."""
    import torch

    from hairfastgan_torch.train.common import tensor_leaves

    leaves = tensor_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = fn(params, *args)[0]
    loss.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return float(loss.detach()), grads


def _gaps(one, other):
    """max |d loss| / |loss|, max |d grad| / max |grad| of `other` against `one`."""
    (l1, g1), (l2, g2) = one, other
    scale = max(float(g.abs().max()) for g in g1)
    return (abs(l2 - l1) / abs(l1),
            max(float((a - b).abs().max()) for a, b in zip(g2, g1)) / scale)


def _banded_runs(zoo32, trip, cfg, dtype, runs):
    """Each of `runs` (name -> swap fn or None for the unbanded hair_fast)
    on the triple `trip`, with every BiSeNet parse (input, labels) and the
    banded final render's raw bands [-1,1] recorded: name -> (final, parses,
    raw final or None)."""
    import torch

    from hairfastgan_torch.models import bisenet
    from hairfastgan_torch.pipeline import blending as B
    from hairfastgan_torch.pipeline.swap import hair_fast

    seg, banded = bisenet.segment_256_nchw, B.sharded_synthesis
    out = {}
    for name, swap in runs.items():
        parses, raw = [], []

        def rec_seg(p, x):
            y = seg(p, x)
            parses.append((x, y))
            return y

        def rec_band(*a, **k):
            r = banded(*a, **k)
            if not k.get("gather", True):
                raw.append(torch.cat([x.to(trip[0].device) for x in r], dim=2))
            return r

        bisenet.segment_256_nchw, B.sharded_synthesis = rec_seg, rec_band
        try:
            with torch.inference_mode():
                final = (hair_fast(zoo32, *trip, cfg=cfg, dtype=dtype) if swap is None
                         else swap(zoo32, *trip))
        finally:
            bisenet.segment_256_nchw, B.sharded_synthesis = seg, banded
        out[name] = (final, parses, raw[0] if raw else None)
    return out


def _replayed(zoo32, trip, swap, parses):
    """The banded swap with every BiSeNet parse replaced, in call order, by
    the labels of `parses` (the unbanded run's): the rest of the swap given
    the same masks."""
    import torch

    from hairfastgan_torch.models import bisenet

    seg, it = bisenet.segment_256_nchw, iter(parses)
    bisenet.segment_256_nchw = lambda p, x: next(it)[1]
    try:
        with torch.inference_mode():
            return swap(zoo32, *trip)
    finally:
        bisenet.segment_256_nchw = seg


def phase_parallel(hf, zoo32, device, card: str, cfg=None) -> dict:
    """The multi-device layer at full width on phase 4's zoos: swap_batch's
    data-parallel branch (f32 rows against B=1 swaps, bf16 against one
    device), the H-band spatially sharded swap over 2 and 4 bands (f32
    against the unbanded swap, its moves and launches, p50 and peak memory
    beside the unbanded swap's, halo=1 load-bearing), and data-parallel
    training (a full-width blending step; the micro discriminator step in
    float64 with its stddev over the global batch). The meshes are the
    visible cards when there are enough, else the one card repeated. `cfg`
    (default HairFastConfig()) is the zoos' config; the bands start at half
    its size (512 at full width)."""
    import torch

    from hairfastgan_torch.api import HairFast
    from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
    from hairfastgan_torch.models import stylegan2_discriminator as Dsc
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.parallel import mesh, spatial
    from hairfastgan_torch.pipeline.swap import hair_fast
    from hairfastgan_torch.scripts import fastpath_agreement
    from hairfastgan_torch.train import blending as TB
    from hairfastgan_torch.train import datagen as Dg
    from hairfastgan_torch.train import pp as P
    from hairfastgan_torch.train.common import (adam_with_clip, make_train_step, shard_loss,
                                                tensor_leaves)
    from hairfastgan_torch.zoo import init_discriminator

    cards = mesh.local_devices(device)

    def devices(n):
        return cards[:n] if len(cards) >= n else [cards[0]] * n

    def moves():
        return {k: v for k, v in mesh.MOVES.items() if v}

    distinct = len(cards) >= 2
    log(f"[parallel] {len(cards)} card(s): the meshes are "
        + ("the visible cards" if distinct else f"[{cards[0]}] * n, the one card repeated: "
           "every line of the sharding runs, which checks the math, not the speed"))
    out = {}
    local = mesh.local_devices
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # 1. swap_batch's data-parallel branch. f32 at zero noise: the
        # branch's per-shard swap over 2 (B=4, 2 rows a shard) against B=1
        # swaps (with noise a shard's 2 rows draw other noise than B=1 does)
        cfg32 = dataclasses.replace(cfg or HairFastConfig(), compute_dtype="float32")
        hf32 = HairFast(cfg32, zoo=zoo32, device=device)
        size = cfg32.stylegan.size
        from_res = size // 2
        rng = np.random.default_rng(15)
        trip = [rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8) for _ in range(3)]
        plan2 = mesh.make_mesh(devices=devices(2))
        reps = mesh.replicate(plan2, zoo32)
        host = [torch.from_numpy(a[:4]) for a in trip]
        host = [h.pin_memory() for h in host] if device.type == "cuda" else host
        mesh.MOVES.clear()
        dp4 = counted("parallel data_parallel B=4 f32", lambda: mesh.data_parallel(
            plan2, lambda z, f, s, c: hf32._serve("distinct", f, s, c, None, False, size, z),
            (False, True, True, True))(reps, *host), at_least=4)
        dp_moves = moves()
        with torch.inference_mode():
            rows = [float((dp4[j] - hair_fast(zoo32, *(h[j:j + 1].to(device) for h in host),
                                              cfg=cfg32)[0]).abs().max()) for j in range(4)]
        mesh.local_devices = lambda d: devices(2)
        mesh.MOVES.clear()
        dp8 = counted("parallel swap_batch B=8 bf16",
                      lambda: hf.swap_batch(*trip, output="uint8"), at_least=4)
        sb_moves = moves()
        mesh.local_devices = lambda d: cards[:1]  # the reference runs on one device
        dev8 = np.abs(dp8.astype(np.int16) - hf.swap_batch(*trip, output="uint8").astype(np.int16))
        mesh.local_devices = local
        n4, n8 = (LAUNCHES[f"parallel {k}"] for k in ("data_parallel B=4 f32",
                                                       "swap_batch B=8 bf16"))
        out["swap_batch"] = {"rows_f32": rows, "bf16_u8_max": int(dev8.max()),
                             "bf16_u8_mean": float(dev8.mean()), "moves": sb_moves}
        log(f"[parallel] swap_batch's per-shard swap, B=4 over 2 at zero noise (f32, TF32 "
            f"off): rows vs B=1 swaps max |diff| {', '.join(f'{r:.2e}' for r in rows)} (limit "
            f"1e-3); moves {dp_moves}; dilate_erode launches {n4} (2 per shard). swap_batch "
            f"B=8 over 2 bf16 uint8 vs one device: max {int(dev8.max())} step(s), mean "
            f"{dev8.mean():.3f} (each shard draws the one seed's noise for its 4 rows, the one "
            f"device for its 8); moves {sb_moves}; launches {n8}  [{card}]")
        # the zoo's Replicas are made on swap_batch's first call with the mesh
        if (max(rows) > 1e-3 or dp_moves != {"scatter": 3, "gather": 1} or n4 != 4 or n8 != 4
                or sb_moves != {"broadcast": 1, "scatter": 3, "gather": 1}):
            raise AssertionError(f"data-parallel swap: rows {rows}, moves {dp_moves} "
                                 f"{sb_moves}, launches {n4} {n8}")
        del hf32, dp4, dp8, reps, host

        # 2. the banded swap, f32, TF32 off, with the generator drawn by its
        # real init's law (weights N(0, 1) under the equalized-lr scale,
        # modulation biases 1): with the random fill's N(0, 0.05)
        # the renders carry almost no signal (halo=1 moved the micro
        # image by 2e-4), and a wrong band would hide under the tolerance
        zoo32 = dict(zoo32, generator=fastpath_agreement.scaled_generator(cfg32.stylegan, 0,
                                                                          device))
        t1 = [torch.from_numpy(a[:1]).to(device) for a in trip]
        swaps = {n: spatial.make_sharded_swap(mesh.make_mesh(devices=devices(n)), cfg=cfg32,
                                              from_res=from_res, halo=8) for n in (2, 4)}
        runs = _banded_runs(zoo32, t1, cfg32, torch.float32, {"plain": None})
        ref, ref_parses, _ = runs["plain"]
        band = {}
        for n, swap in swaps.items():
            mesh.MOVES.clear()
            runs.update(counted(f"parallel banded swap n={n}", lambda: _banded_runs(
                zoo32, t1, cfg32, torch.float32, {n: swap}), at_least=2))
            got, parses, _ = runs[n]
            err = float((got - ref).abs().max())
            flips = sum(int((y != yr).sum()) for (_, y), (_, yr) in zip(parses, ref_parses))
            render = max(float((x - xr).abs().max()) for (x, _), (xr, _) in zip(parses, ref_parses))
            band[n] = {"err": err, "flips": flips, "render_err": render, "moves": moves(),
                       "launches": LAUNCHES[f"parallel banded swap n={n}"]}
            if err > 1e-3:  # a label flipped on a near-tie: hold the renders and the rest
                band[n]["replayed_err"] = float((_replayed(zoo32, t1, swap, ref_parses)
                                                 - ref).abs().max())
            log(f"[parallel] banded swap over {n} (from_res {from_res}, halo 8, f32, TF32 off) vs the "
                f"unbanded swap: max |diff| {err:.2e} (limit 1e-3); BiSeNet labels flipped "
                f"{flips}; parsed renders max |diff| {render:.2e}; "
                + (f"with the unbanded labels {band[n]['replayed_err']:.2e}; " if err > 1e-3
                   else "") + f"moves {band[n]['moves']}; dilate_erode launches "
                f"{band[n]['launches']}  [{card}]")
            # the generator is copied to the band cards once, when they are distinct
            want = {"scatter": 4, "gather": 4,
                    **({"broadcast": 1} if len(set(devices(n))) > 1 else {})}
            held = err <= 1e-3 or (flips > 0 and render <= 1e-4
                                   and band[n]["replayed_err"] <= 1e-3)
            if not held or band[n]["moves"] != want or band[n]["launches"] != 2:
                raise AssertionError(f"banded swap over {n}: {band[n]}")
        out["banded"] = band

        # halo=1 over 4 bands: the halo is load-bearing
        h1 = spatial.make_sharded_swap(mesh.make_mesh(devices=devices(4)), cfg=cfg32,
                                       from_res=from_res, halo=1)
        runs.update(_banded_runs(zoo32, t1, cfg32, torch.float32, {"halo1": h1}))
        h1_err = float((runs["halo1"][0] - ref).abs().max())
        h1_raw = float((runs["halo1"][2] - runs[4][2]).abs().max())
        out["halo1"] = (h1_err, h1_raw)
        log(f"[parallel] halo=1 over 4 bands: final image vs the unbanded swap max |diff| "
            f"{h1_err:.3e}; raw final render [-1,1] vs halo=8's {h1_raw:.3e} (either must "
            f"exceed 1e-2)")
        if max(h1_err, h1_raw) <= 1e-2:
            raise AssertionError(f"halo=1 is as good as halo=8: {out['halo1']}")
        del runs, ref_parses

        # p50 of 5 swaps each, bf16 (the serving dtype), in turns; peak memory
        bswaps = {"unbanded": lambda: hair_fast(hf.zoo, *t1, cfg=hf.cfg, dtype=hf.dtype)}
        for n in (2, 4):
            sw = spatial.make_sharded_swap(mesh.make_mesh(devices=devices(n)), cfg=hf.cfg,
                                           dtype=hf.dtype, from_res=from_res, halo=8)
            bswaps[f"banded n={n}"] = lambda sw=sw: sw(hf.zoo, *t1)
        ms, peak = collections.defaultdict(list), {}
        with torch.inference_mode():
            for name, fn in bswaps.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                fn()
                torch.cuda.synchronize()
                peak[name] = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
            for _ in range(5):
                for name, fn in bswaps.items():
                    ms[name].append(_event_ms(fn)[1])
        out["p50"] = {k: statistics.median(v) for k, v in ms.items()}
        out["peak"] = peak
        log(f"[parallel] swap bf16 B=1 p50 of 5 (CUDA events, in turns): "
            + "; ".join(f"{k} {out['p50'][k]:.2f} ms (peak {peak[k]:.2f} GiB above resident)"
                        for k in bswaps)
            + ("" if distinct else "; one card: the bands run one after another, so this is "
               "the cost of the banding, not a multi-card latency")
            + f"  [{card}]")

        # 3. data-parallel training: one full-width blending step over 2
        rng = np.random.default_rng(16)
        face, shape, color = (torch.from_numpy(rng.random((2, size, size, 3), np.float32))
                              .to(device) for _ in range(3))
        row = Dg.generate_blending_sample(zoo32, face, shape, color, cfg32)
        blend_row = row_abi(cfg32, 2)[0]
        batch = tuple(row[k] for k in blend_row)
        crops = torch.cat([row["face_i"] * row["target_mask"], row["color_i"] * row["HM_3E"]])
        frozen = {"generator": zoo32["generator"],
                  "clip": _centered_clip(zoo32["blending"]["clip"], crops)}
        plan = mesh.make_mesh(devices=devices(2))
        lr = 1e-3

        def loss_fn(p, fr, *b):
            return TB.blending_loss(p, fr, b, cfg32)

        def mods():
            return {"mods": map_tree(zoo32["blending"]["mods"], lambda _, t: t.clone())}

        one = _loss_grads(mods(), loss_fn, frozen, *batch)
        reps = mesh.replicate(plan, frozen)
        two = _loss_grads(mods(), shard_loss(plan, loss_fn), reps, *batch)
        d_loss, d_grad = _gaps(one, two)
        # the steps run at 1e-3 of the loss (as phase 10's card-vs-CPU steps):
        # Adam's first step is lr * sign(g) for |g| >> eps, so a coordinate
        # whose gradient is at the f32 noise floor could flip by 2 lr; at
        # 1e-3 of it every coordinate's step stays linear in g
        def scaled(p, fr, *b):
            loss, aux = loss_fn(p, fr, *b)
            return loss * 1e-3, aux

        after = []
        for pl in (None, plan):
            tx = adam_with_clip(lr)
            step = make_train_step(scaled, tx, frozen=frozen, plan=pl)
            params = mods()
            mesh.MOVES.clear()
            step(params, tx.init(params), *batch)
            after.append(([t.detach() for t in tensor_leaves(params)], moves()))
        d_param = max(float((a - b).abs().max()) for a, b in zip(after[0][0], after[1][0]))
        out["blend_step"] = (one[0], d_loss, d_grad, d_param, after[1][1])
        log(f"[parallel] blending step B=2 at {size}^2 over 2 vs one device (f32, TF32 off, CLIP "
            f"centred on the batch's crops, the Adam step at 1e-3 of the loss): loss {one[0]:.6f}, max |d loss| {d_loss:.2e} of it; "
            f"max |d grad| {d_grad:.2e} of max |grad|; max |d param| after Adam {d_param:.2e} "
            f"(lr {lr}); limits (1e-5, 1e-4, lr/5); a step's moves {after[1][1]}  [{card}]")
        want = {"scatter": 8, "broadcast": 1, "reduce": 1}
        if d_loss > 1e-5 or d_grad > 1e-4 or d_param > lr / 5 or after[1][1] != want:
            raise AssertionError(f"data-parallel blending step: {out['blend_step']}")
        del one, two, reps, after, frozen, row, batch, crops

        # the micro discriminator step at B=8 over 2 in float64
        d = map_tree(init_discriminator(StyleGANConfig(size=128, max_channels=32), seed=6,
                                        device=device), lambda _, t: t.double())
        drng = np.random.default_rng(17)
        real, fake = (torch.from_numpy(drng.uniform(-1, 1, (8, 128, 128, 3))).to(device)
                      for _ in range(2))

        def dcopy():
            return map_tree(d, lambda _, t: t.clone())

        mesh.MOVES.clear()
        one = _loss_grads(dcopy(), P.pp_disc_loss, real, fake)
        two = _loss_grads(dcopy(), lambda p, r, f: P.pp_disc_loss(p, r, f, plan), real, fake)
        d_moves = moves()
        gaps = _gaps(one, two)
        after = []
        for pl in (None, plan):
            _, dstep, r1_step, _, d_tx = P.make_pp_train_steps({}, lr=lr, use_adv=True, plan=pl)
            params = dcopy()
            dstep(params, d_tx.init(params), real, fake)
            after.append(([t.detach() for t in tensor_leaves(params)], float(r1_step(d, real))))
        d_param = max(float((a - b).abs().max()) for a, b in zip(after[0][0], after[1][0]))
        with torch.no_grad():
            logits = Dsc.discriminator(d, real)
            per_shard = torch.cat([Dsc.discriminator(d, x) for x in real.chunk(2)])
        shard_gap = float((per_shard - logits).abs().max())
        r1_gap = abs(after[1][1] - after[0][1]) / abs(after[0][1])
        out["disc_step"] = (abs(two[0] - one[0]), gaps[1], d_param, r1_gap, shard_gap, d_moves)
        log(f"[parallel] discriminator step (128^2 at 32 channels, float64) B=8 over 2 vs one "
            f"device: |d loss| {abs(two[0] - one[0]):.2e}, max |d grad| {gaps[1]:.2e} of max "
            f"|grad|, max |d param| after Adam {d_param:.2e}, R1 {r1_gap:.2e} relative (limit "
            f"1e-10 each); per-shard stddev groups would move the logits by {shard_gap:.3e}; "
            f"moves {d_moves}  [{card}]")
        want = {"broadcast": 1, "scatter": 4, "gather": 2, "reduce": 1}
        if (max(abs(two[0] - one[0]), gaps[1], d_param, r1_gap) > 1e-10 or shard_gap <= 1e-6
                or d_moves != want):
            raise AssertionError(f"data-parallel discriminator step: {out['disc_step']}")
    finally:
        mesh.local_devices = local
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()
    return out


def _profiled(fn, n: int = 3):
    """(device events, device busy ms) per call of fn over n calls
    (torch.profiler, as phase 6 counts them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ev) / n, sum(e.device_time for e in ev) / n / 1e3


def _swaps_in_turns(variants: dict, imgs, device, n: int) -> dict:
    """Each HairFast of `variants` swaps `imgs` (bf16, B=1) n times, the
    variants in turns (order reversed every other round); per variant: p50,
    min and max ms by CUDA events, device events and busy ms per swap
    (torch.profiler over 3 more), the idle share of the p50, and the peak
    memory of one more swap above the resident."""
    import torch

    names = list(variants)
    for name in names:  # warm-up
        variants[name].swap_tensor(*imgs, seed=3407)
    torch.cuda.synchronize()
    ms = {k: [] for k in names}
    for i in range(n):
        for name in (names if i % 2 == 0 else names[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            variants[name].swap_tensor(*imgs, seed=3407 + i)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    out = {}
    for name in names:
        p50 = statistics.median(ms[name])
        hf = variants[name]
        events, busy = _profiled(lambda: hf.swap_tensor(*imgs, seed=3407))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        hf.swap_tensor(*imgs, seed=3407)
        torch.cuda.synchronize()
        out[name] = {"p50": p50, "min": min(ms[name]), "max": max(ms[name]), "events": events,
                     "busy_ms": busy, "idle": 1 - busy / p50,
                     "peak_gib": (torch.cuda.max_memory_allocated(device) - resident) / 2 ** 30}
    return out


def _log_turns(label: str, rows: dict, card: str) -> None:
    for name, r in rows.items():
        log(f"[fastpaths] {label} {name}: bf16 B=1 swap p50 {r['p50']:.2f} ms (min "
            f"{r['min']:.2f} max {r['max']:.2f}, CUDA events, in turns); {r['events']:.0f} "
            f"device events, {r['busy_ms']:.2f} ms busy per swap, idle share {r['idle']:.3f}, "
            f"peak {r['peak_gib']:.3f} GiB above resident  [{card}]")


def _scaled_shape_adaptor(seed: int, device):
    """The full-width shape adaptor with the JAX package's init law, from a
    numpy seed: conv weights 0.02 * N(0,1), linear weights N(0,1) /
    sqrt(fan-in), layer-norm gammas U(0,1), betas and biases 0 (drawn in
    JAX layout and the tree's key order)."""
    import torch

    from hairfastgan_torch.models import shape_adaptor
    from hairfastgan_torch.params.bridge import map_tree, to_port

    rng = np.random.default_rng(seed)

    def leaf(key, t):
        shape = tuple(t.shape)
        if key == "w":  # conv [kh,kw,I,O] or linear [in,out]
            scale = 0.02 if len(shape) == 4 else 1.0 / np.sqrt(shape[0])
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        elif key == "gamma":
            a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        else:
            a = np.zeros(shape, np.float32)
        return to_port(key, torch.from_numpy(a)).to(device)

    return map_tree(shape_adaptor.init_shape_adaptor(), leaf)


def phase_fastpaths(hf, zoo32, imgs, device, card: str) -> dict:
    """The opt-in fast paths at full width on phase 4's zoos, each held
    against the default path and timed beside it in turns: paired shape
    modules (f32 zero-noise shape modules and swap against the sequential
    ones; bf16 p50, events, idle share, peak memory), the packed zoo (f32
    swap against the unpacked; bf16 swap and e4e_encode / fs_encode /
    sean_decode at the swap's shapes), the fused up-blur (every up
    StyledConv, 8^2 to 1024^2: ms, device us, f32 difference) and the
    rotate render's two cuts (bf16 p50), then scripts/fastpath_agreement
    --n 16 on the card."""
    import torch

    from hairfastgan_torch.api import HairFast
    from hairfastgan_torch.models import e4e, iresnet, sean
    from hairfastgan_torch.ops.modconv import modulated_conv2d
    from hairfastgan_torch.pipeline import alignment as A
    from hairfastgan_torch.pipeline import embedding as E
    from hairfastgan_torch.pipeline.swap import hair_fast
    from hairfastgan_torch.scripts import fastpath_agreement
    from hairfastgan_torch.scripts.upload_res_agreement import BISENET_SEED, scaled_bisenet
    from hairfastgan_torch.zoo import pack_zoo

    out = {}
    cfg = hf.cfg
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    trip = [torch.from_numpy(im)[None].to(device) for im in imgs]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    # the generator, BiSeNet and the shape adaptor by their init laws: with
    # the flat 0.05 fill the renders parse to no hair and the adaptor's
    # target has none, and no label check can use an all-zero HM_X
    zoo32 = dict(zoo32, generator=fastpath_agreement.scaled_generator(cfg.stylegan, 0, device),
                 bisenet=scaled_bisenet(BISENET_SEED, device),
                 shape_adaptor=_scaled_shape_adaptor(0, device))
    try:
        with torch.inference_mode():
            # 1. paired shape modules against the sequential ones, f32, zero noise
            emb = E.embed_images(zoo32, torch.cat(trip), mix=True, cfg=cfg32,
                                 dtype=torch.float32)
            face, shape, color = ({k: v[j:j + 1] for k, v in emb.items()} for j in range(3))
            pair = counted("shape_module_pair", lambda: A.shape_module_pair(
                zoo32, face, shape, color, cfg=cfg32, dtype=torch.float32), at_least=0)
            seq = [A.shape_module(zoo32, face, e2, cfg=cfg32, dtype=torch.float32)
                   for e2 in (shape, color)]
            agreement = {}
            for which, got, ref in zip(("shape", "color"), pair, seq):
                for k in ("hair_mask1", "hair_mask2"):
                    if not torch.equal(got[k], ref[k]):
                        raise AssertionError(f"paired {which} {k} differs from the sequential")
                for k in ("target_mask", "rot_mask", "HM_X"):
                    agreement[f"{which}.{k}"] = float((got[k] == ref[k]).float().mean())
            bad = {k: v for k, v in agreement.items() if v < 0.999}
            hair = [float(sm["HM_X"].mean()) for sm in (*pair, *seq)]
            n_labels = len(torch.unique(pair[0]["rot_mask"]))
            log(f"[fastpaths] paired shape modules vs sequential (f32, TF32 off, zero noise; "
                f"generator, BiSeNet and shape adaptor by their init laws): hair masks equal; "
                f"label agreement {agreement}; {n_labels} classes in the rotated parse; target "
                f"hair share (paired shape, color; sequential shape, color) "
                f"{', '.join(f'{h:.4f}' for h in hair)}")
            if bad:
                raise AssertionError(f"paired shape modules agree below 99.9%: {bad}")
            if not all(0.0 < h < 1.0 for h in hair):  # an all-or-no-hair target agrees trivially
                raise AssertionError(f"trivial target masks, hair shares {hair}")
            cfg32p = dataclasses.replace(cfg32, pair_shape_modules=True)
            seq_img = hair_fast(zoo32, *trip, cfg=cfg32, dtype=torch.float32)
            pair_img = counted("swap_paired_f32", lambda: hair_fast(
                zoo32, *trip, cfg=cfg32p, dtype=torch.float32), at_least=2)
            pair_err = float((pair_img - seq_img).abs().max())
            log(f"[fastpaths] paired swap vs sequential, f32 zero noise: max |diff| "
                f"{pair_err:.3e} (limit 1e-3), {LAUNCHES['swap_paired_f32']} launches")
            if pair_err > 1e-3:
                raise AssertionError(f"paired swap off the sequential by {pair_err}")
            out["paired_f32"] = (agreement, pair_err)

            # 2. the packed zoo against the unpacked, f32
            packed32 = pack_zoo(zoo32)
            pk_img = counted("swap_packed_f32", lambda: hair_fast(
                packed32, *trip, cfg=cfg32, dtype=torch.float32), at_least=2)
            d = (pk_img - seq_img).abs()
            pk_err = (float(d.max()), float(d.mean()))
            log(f"[fastpaths] packed-zoo swap vs unpacked, f32: max |diff| {pk_err[0]:.3e} "
                f"(limit 5e-3), mean {pk_err[1]:.3e} (limit 2e-4)")
            if pk_err[0] > 5e-3 or pk_err[1] > 2e-4:
                raise AssertionError(f"packed-zoo swap off the unpacked: {pk_err}")
            out["packed_f32"] = pk_err
            del packed32, emb, pair, seq, seq_img, pair_img, pk_img
            torch.cuda.empty_cache()

            # 3. the fused up-blur: every up StyledConv of the generator
            rng = np.random.default_rng(17)
            blur_rows = []
            for pair_i in range(1, cfg.stylegan.log_size - 1):
                p16 = hf.zoo["generator"]["convs"][2 * pair_i - 2]["conv"]
                p32 = zoo32["generator"]["convs"][2 * pair_i - 2]["conv"]
                cin, res = p16["w"].shape[1], 4 * 2 ** (pair_i - 1)
                x = torch.from_numpy(rng.standard_normal((1, cin, res, res), dtype=np.float32)
                                     ).to(device)
                st = torch.from_numpy(rng.standard_normal((1, 512), dtype=np.float32)).to(device)
                ref = modulated_conv2d(p32, x, st, up=True)
                err = float((modulated_conv2d(p32, x, st, up=True, fuse_blur=True)
                             - ref).abs().max())
                scale = float(ref.abs().max())
                x16, s16 = x.bfloat16(), st.bfloat16()
                two = lambda: modulated_conv2d(p16, x16, s16, up=True)  # noqa: E731
                fused = lambda: modulated_conv2d(p16, x16, s16, up=True, fuse_blur=True)  # noqa: E731
                for f in (two, fused):
                    cuda_ms(f, 5)
                n = 50 if res <= 128 else 20
                t1, f1, f2, t2 = (cuda_ms(f, n) for f in (two, fused, fused, two))
                du_two, du_fused = device_us(two, 10), device_us(fused, 10)
                blur_rows.append((res, 2 * res, cin, (t1 + t2) / 2, (f1 + f2) / 2,
                                  du_two, du_fused, err))
                log(f"[fastpaths] up StyledConv {res}^2 -> {2 * res}^2, {cin} ch, bf16 B=1: "
                    f"two-pass {(t1 + t2) / 2:.4f} ms, fused {(f1 + f2) / 2:.4f} ms per call "
                    f"(order two,fused,fused,two: {t1:.4f} {f1:.4f} {f2:.4f} {t2:.4f}); device "
                    f"only two-pass {du_two:.1f} us, fused {du_fused:.1f} us; f32 max |diff| "
                    f"{err:.3e} of max |y| {scale:.3e}  [{card}]")
                if not err <= 1e-4 * scale:  # the CPU tests' rtol
                    raise AssertionError(f"fused up-blur at {res}^2 off the two-pass by {err}")
            out["fuse_blur"] = blur_rows
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    # bf16 swaps in turns: default, paired, packed
    packed16 = pack_zoo(hf.zoo)
    hf_pair = HairFast(dataclasses.replace(cfg, pair_shape_modules=True), zoo=hf.zoo,
                       device=device)
    hf_pack = HairFast(cfg, zoo=packed16, device=device)
    for name, h in (("swap_paired", hf_pair), ("swap_packed", hf_pack)):
        counted(name, lambda: h.swap_tensor(*imgs, seed=3407), at_least=2)
        if LAUNCHES[name] != 2:
            raise AssertionError(f"{name}: {LAUNCHES[name]} kernel launches, expected 2")
    rows = _swaps_in_turns({"default": hf, "paired": hf_pair, "packed": hf_pack}, imgs,
                           device, n=10)
    _log_turns("swaps", rows, card)
    out["swaps"] = rows

    # the packed modules at the swap's shapes: e4e B=3, fs_encode B=2, sean_decode B=2
    dt = hf.dtype
    mods = {}
    with torch.inference_mode():
        x3 = torch.from_numpy(rng.uniform(-1, 1, (3, 256, 256, 3)).astype(np.float32)).to(
            device, dt)
        codes = torch.from_numpy(rng.standard_normal((2, 19, 512)).astype(np.float32) * 0.5
                                 ).to(device, dt)
        labels = torch.from_numpy(np.repeat(np.repeat(rng.integers(0, 19, (2, 16, 16)), 16, 1),
                                            16, 2).astype(np.int32)).to(device)
        calls = {"e4e_encode B=3": (lambda z: e4e.e4e_encode(z["e4e"], x3)),
                 "fs_encode B=2": (lambda z: iresnet.fs_encode(z["fse"], x3[:2])),
                 "sean_decode B=2": (lambda z: sean.sean_decode(z["sean"], codes, labels))}
        for name, call in calls.items():
            unpacked, packed = (lambda: call(hf.zoo)), (lambda: call(packed16))
            for f in (unpacked, packed):
                cuda_ms(f, 3)
            u1, p1, p2, u2 = (cuda_ms(f, 10) for f in (unpacked, packed, packed, unpacked))
            ev_u, busy_u = _profiled(unpacked)
            ev_p, busy_p = _profiled(packed)
            mods[name] = {"unpacked_ms": (u1 + u2) / 2, "packed_ms": (p1 + p2) / 2,
                          "unpacked_events": ev_u, "packed_events": ev_p,
                          "unpacked_busy_ms": busy_u, "packed_busy_ms": busy_p}
            log(f"[fastpaths] {name} bf16: unpacked {(u1 + u2) / 2:.3f} ms, {ev_u:.0f} events "
                f"({busy_u:.3f} ms busy); packed {(p1 + p2) / 2:.3f} ms, {ev_p:.0f} events "
                f"({busy_p:.3f} ms busy) per call (order u,p,p,u: {u1:.3f} {p1:.3f} {p2:.3f} "
                f"{u2:.3f})  [{card}]")
    out["modules"] = mods
    del hf_pack, packed16
    torch.cuda.empty_cache()

    # 4. the rotate render's cuts: bf16 p50 in turns, then the label agreement
    rot = {"rot_render_pairs=6": dict(rot_render_pairs=6),
           "rot_seg_size=512": dict(rot_seg_size=512),
           "both": dict(rot_render_pairs=6, rot_seg_size=512)}
    variants = {"default": hf}
    for name, kw in rot.items():
        variants[name] = HairFast(dataclasses.replace(cfg, **kw), zoo=hf.zoo, device=device)
        counted(f"swap_{name}", lambda: variants[name].swap_tensor(*imgs, seed=3407),
                at_least=2)
    rows = _swaps_in_turns(variants, imgs, device, n=5)
    _log_turns("rotate cuts", rows, card)
    out["rotate"] = rows
    t0 = time.perf_counter()
    agreement = counted("fastpath_agreement", lambda: fastpath_agreement.main(
        ["--n", "16", "--device", str(device)]), at_least=0)
    log(f"[fastpaths] fastpath_agreement --n 16 --device {device} ({time.perf_counter() - t0:.1f} "
        f"s; random weights, a reading, not a verdict): {json.dumps(agreement)}  [{card}]")
    out["agreement"] = agreement
    torch.cuda.empty_cache()
    return out


# all_gathers of the column-parallel generator at full width (StyleGAN2-FFHQ
# 1024^2, channel_multiplier 2): one per split leaf that a call runs through,
# the weights of the split layers never move. mapping: its 8 linears; a
# render: the constant input, conv1 (style, output), to_rgb1 (style), pairs
# 1-4 at 512 channels (two convs' styles and outputs and the ToRGB style: 5
# each) and pair 5's up conv style (its input has 512 channels, its output
# 256); G[0..3]: the render's first 19; G[4..8] from F: pairs 4 and 5's 6
MODEL_AXIS_GATHERS = {"mapping": 8, "render": 25, "g03": 19, "g48": 6}
MODEL_AXIS_SPLIT = 33  # leaves the model axis splits: the gathers' 8 + 25


def phase_model_axis(device, card: str) -> dict:
    """The model axis at full width: the StyleGAN2-FFHQ generator at 1024^2
    (18 latents, drawn by its init law from a numpy seed) placed by
    parallel.mesh.shard_params_model_axis on (1, 2), (1, 4) and (2, 2)
    meshes of the one card repeated ([cuda:0] * n: the math, not multi-card
    speed) and run column-parallel (parallel/tensor.py): mapping ->
    latent_to_wplus -> generate at B=2, G[0..3] and G[4..8] from F, each in
    f32 against the unsharded call within 1e-4 of max |y| (TF32 off); the
    bf16 render's mean |diff| from the unsharded f32 render at most twice
    the unsharded bf16 render's own; the exact all_gather counts; the H
    bands of MeshPlan.spatial() against slices of the render; bf16 p50 (CUDA
    events, in turns) and peak memory beside the unsharded render's. The
    path launches no dilate_erode (the generator has none)."""
    import torch

    from hairfastgan_torch.config import StyleGANConfig
    from hairfastgan_torch.models import stylegan2 as G
    from hairfastgan_torch.parallel import mesh, tensor
    from hairfastgan_torch.scripts import fastpath_agreement
    from hairfastgan_torch.zoo import cast_zoo

    sg = StyleGANConfig()
    gen = fastpath_agreement.scaled_generator(sg, 0, device)
    gen["style"] = mapping_init(1, sg, device)["style"]  # w off its biases
    gen16 = cast_zoo(gen, torch.bfloat16)
    n_split = sum(d is not None for d in _tree_values(mesh.model_split_dims(gen, 2)))
    if n_split != MODEL_AXIS_SPLIT:
        raise AssertionError(f"the model axis splits {n_split} generator leaves, expected "
                             f"{MODEL_AXIS_SPLIT}")
    z = torch.from_numpy(np.random.default_rng(18).standard_normal((2, 512), dtype=np.float32)
                         ).to(device)

    def moves():
        return {k: v for k, v in mesh.MOVES.items() if v}

    out = {"meshes": {}}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            w1 = G.mapping(gen, z, sg)
            lat = G.latent_to_wplus(w1, sg.n_latent)
            img1 = G.generate(gen, lat, cfg=sg)
            f1, s1 = G.synthesis(gen, lat, start_layer=0, end_layer=3, cfg=sg,
                                 dtype=torch.float32)
            g48 = G.synthesis(gen, lat, start_layer=4, end_layer=8, layer_in=f1, skip=s1,
                              cfg=sg, dtype=torch.float32)
            img16 = G.generate(gen16, lat, cfg=sg, dtype=torch.bfloat16)
            own16 = float((img16.float() - img1).abs().mean())
            scale = float(img1.abs().max())
            for shape in ((1, 2), (1, 4), (2, 2)):
                name = "x".join(map(str, shape))
                plan = mesh.make_mesh(*shape, devices=[device] * (shape[0] * shape[1]))
                tp = mesh.shard_params_model_axis(plan, gen)
                calls = {}

                def run(key, fn):
                    mesh.MOVES.clear()
                    res = counted(f"model_axis {name} {key}", fn, at_least=0)
                    calls[key] = moves()
                    if calls[key].get("all_gather") != MODEL_AXIS_GATHERS[key]:
                        raise AssertionError(f"model axis {name} {key}: moves {calls[key]}, "
                                             f"expected {MODEL_AXIS_GATHERS[key]} all_gathers")
                    return res

                w = run("mapping", lambda: tensor.mapping(tp, z, sg))
                img = run("render", lambda: tensor.generate(
                    tp, G.latent_to_wplus(w, sg.n_latent), cfg=sg))
                f, s = run("g03", lambda: tensor.synthesis(tp, lat, start_layer=0, end_layer=3,
                                                           cfg=sg, dtype=torch.float32))
                g = run("g48", lambda: tensor.synthesis(
                    tp, lat, start_layer=4, end_layer=8, layer_in=f1, skip=s1, cfg=sg,
                    dtype=torch.float32))
                errs = {"mapping": (w, w1), "render": (img, img1), "g03 features": (f, f1),
                        "g03 skip": (s, s1), "g48 features": (g[0], g48[0]),
                        "g48 skip": (g[1], g48[1])}
                errs = {k: (float((a - b).abs().max()), float(b.abs().max()))
                        for k, (a, b) in errs.items()}
                bad = {k: e for k, e in errs.items() if not e[0] <= 1e-4 * e[1]}
                tp16 = mesh.shard_params_model_axis(plan, gen16)
                img16m = tensor.generate(tp16, lat, cfg=sg, dtype=torch.bfloat16)
                got16 = float((img16m.float() - img1).abs().mean())
                max16 = float((img16m.float() - img16.float()).abs().max())
                bands = mesh.place(plan, img, plan.spatial())
                n_band = shape[1]
                h = img.shape[1] // n_band
                band_ok = all(torch.equal(bands[k], img[:, j * h:(j + 1) * h])
                              for k, (_, j) in enumerate(np.ndindex(*shape)))
                log(f"[model_axis] {name} mesh on [{device}] * {shape[0] * shape[1]}: f32 max "
                    f"|diff| vs unsharded (of max |y|): " + ", ".join(
                        f"{k} {e[0]:.3e} ({e[1]:.3e})" for k, e in errs.items())
                    + f" (limit 1e-4 of max |y|); bf16 render mean |diff| from the f32 render "
                    f"{got16:.3e}, unsharded bf16's own {own16:.3e} (limit 2x), max |diff| from "
                    f"the unsharded bf16 render {max16:.3e}; moves {calls}; {n_band} H bands "
                    f"{'equal' if band_ok else 'DIFFER from'} the render's slices")
                if bad:
                    raise AssertionError(f"model axis {name} off the unsharded calls: {bad}")
                if not (np.isfinite(got16) and got16 <= 2 * own16):
                    raise AssertionError(f"model axis {name} bf16 render off by {got16} "
                                         f"(unsharded bf16 {own16})")
                if not band_ok:
                    raise AssertionError(f"model axis {name}: spatial bands differ")
                out["meshes"][name] = {"errs": errs, "bf16_mean": got16, "bf16_max": max16,
                                       "tp16": tp16}
            out["bf16_own"], out["scale"] = own16, scale
            del w, img, f, s, g, f1, s1, g48, img16, img16m, tp, bands
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    # bf16 B=2 renders in turns (order reversed every other round), p50 by
    # CUDA events; peak memory of one render above what is resident
    renders = {"unsharded": lambda: G.generate(gen16, lat, cfg=sg, dtype=torch.bfloat16)}
    for name, m in out["meshes"].items():
        renders[name] = (lambda tp: lambda: tensor.generate(tp, lat, cfg=sg,
                                                            dtype=torch.bfloat16))(m.pop("tp16"))
    times = {k: [] for k in renders}
    peak = {}
    with torch.inference_mode():
        for k, fn in renders.items():
            cuda_ms(fn, 2)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            fn()
            torch.cuda.synchronize()
            peak[k] = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
        for r in range(10):
            for k in (list(renders) if r % 2 == 0 else list(renders)[::-1]):
                times[k].append(cuda_ms(renders[k], 1))
    out["p50"] = {k: statistics.median(v) for k, v in times.items()}
    out["peak_gib"] = peak
    log(f"[model_axis] generate bf16 B=2 1024^2 p50 of 10 (CUDA events, in turns; one card: "
        f"the meshes run every position's work on it, so this reads the math's cost, not "
        f"multi-card speed): " + ", ".join(
            f"{k} {out['p50'][k]:.2f} ms (min {min(times[k]):.2f}, max {max(times[k]):.2f}; "
            f"peak {peak[k]:.3f} GiB)" for k in renders) + f"  [{card}]")
    del renders, gen, gen16
    torch.cuda.empty_cache()
    return out


MODEL_AXIS_SWAP_MESHES = ((1, 2), (2, 2))
MODEL_AXIS_OPTINS = {  # phase 18's (1, 2) cases: (cfg changes, packed zoo)
    "paired": (dict(pair_shape_modules=True), False),
    "cut": (dict(rot_render_pairs=6, rot_seg_size=512), False),
    "packed": ({}, True),
    "all": (dict(pair_shape_modules=True, rot_render_pairs=6, rot_seg_size=512), True),
}
HEAD_KINDS = ("conv0", "chain", "lin_b")  # the keys of e4e's styles_packed groups
PACKED_KINDS = HEAD_KINDS + ("gb", "conv_gb", "fc_mu_b", "styles_b")


def _split_packed(dims, kind=None, heads=False) -> list:
    """The kind (PACKED_KINDS) of every split leaf of a split-dims tree
    that lies under a packed key, one entry per leaf (HEAD_KINDS only
    under e4e's styles_packed: SEAN's blocks have a conv0 of their own)."""
    if isinstance(dims, dict):
        return [x for k in dims for x in _split_packed(
            dims[k], k if k in PACKED_KINDS and (heads or k not in HEAD_KINDS) else kind,
            heads or k == "styles_packed")]
    if isinstance(dims, list):
        return [x for v in dims for x in _split_packed(v, kind, heads)]
    return [kind] if dims is not None and kind is not None else []


def _model_axis_optins(zoo32, trip, cfg32, cfg16, device, card) -> dict:
    """Phase 18's cases on the (1, 2) mesh: the fast-path opt-ins and a
    packed zoo, alone and all together (MODEL_AXIS_OPTINS), each in f32
    (TF32 off, zero noise) against the one-device swap with the same config
    and zoo (1e-3 of max |y|, HM_X agreement >= 0.999, 2 launches) and in
    bf16 with the f32 moves; the packed leaves the full-width placement
    splits (gb and conv_gb must be among them); and make_sharded_swap over
    2 bands of [cuda:0] * 2 handed the model-axis zoo, against the same
    banded swap on the whole zoo."""
    import torch

    from hairfastgan_torch.parallel import mesh, spatial
    from hairfastgan_torch.pipeline.swap import hair_fast
    from hairfastgan_torch.zoo import cast_zoo, pack_zoo

    def moves():
        return {k: v for k, v in mesh.MOVES.items() if v}

    plan = mesh.make_mesh(1, 2, devices=[device] * 2)
    zoos = {False: zoo32, True: pack_zoo(zoo32)}
    placed = {k: mesh.shard_params_model_axis(plan, z) for k, z in zoos.items()}
    kinds = collections.Counter(_split_packed(placed[True].dims))
    log(f"[model_axis_swap] packed zoo on (1, 2): split packed leaves by kind {dict(kinds)} "
        f"({sum(kinds.values())} in all)")
    if not {"gb", "conv_gb"} <= set(kinds):
        raise AssertionError(f"the packed SEAN gb / conv_gb do not split at full width: {kinds}")
    out = {"split_packed": dict(kinds), "cases": {}}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for name, (changes, packed) in MODEL_AXIS_OPTINS.items():
        c32, c16 = (dataclasses.replace(c, **changes) for c in (cfg32, cfg16))
        zoo, tp = zoos[packed], placed[packed]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                ref, ref_inter = hair_fast(zoo, *trip, cfg=c32, dtype=torch.float32,
                                           return_intermediate=True)
                mesh.MOVES.clear()
                got, inter = counted(f"model_axis_swap {name} f32", lambda: hair_fast(
                    tp, *trip, cfg=c32, dtype=torch.float32, return_intermediate=True),
                    at_least=2)
                f32 = moves()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        agree = float((inter["HM_X"] == ref_inter["HM_X"]).float().mean())
        hair = float(ref_inter["HM_X"].mean())
        del ref, ref_inter, got, inter
        tp16 = mesh.shard_params_model_axis(plan, cast_zoo(zoo, torch.bfloat16))
        with torch.inference_mode():
            mesh.MOVES.clear()
            counted(f"model_axis_swap {name} bf16", lambda: hair_fast(
                tp16, *trip, cfg=c16, dtype=torch.bfloat16), at_least=2)
        bf16 = moves()
        del tp16
        launches = (LAUNCHES[f"model_axis_swap {name} f32"],
                    LAUNCHES[f"model_axis_swap {name} bf16"])
        out["cases"][name] = {"err": err, "scale": scale, "agree": agree, "hair": hair,
                              "moves": f32, "moves_bf16": bf16, "launches": launches}
        log(f"[model_axis_swap] (1, 2) {name} {changes}{' packed zoo' if packed else ''}, B=2 "
            f"f32 zero noise (TF32 off) vs the one-device swap with the same config and zoo: "
            f"max |diff| {err:.3e} of max |y| {scale:.4f} (limit 1e-3 of it); HM_X hair labels "
            f"agree on {agree:.6f} (hair share {hair:.4f}); moves per swap f32 {f32}, bf16 "
            f"{bf16}; dilate_erode launches f32 / bf16 {launches[0]} / {launches[1]}  [{card}]")
        if not err <= 1e-3 * scale or agree < 0.999 or launches != (2, 2) or bf16 != f32:
            raise AssertionError(f"model-axis swap {name}: |diff| {err} of {scale}, HM_X "
                                 f"agreement {agree}, launches {launches}, moves f32 {f32} "
                                 f"bf16 {bf16}")
        if not 0.0 < hair < 1.0:
            raise AssertionError(f"{name}: the f32 swap's target hair share is {hair}")

    # make_sharded_swap handed the model-axis zoo: gathered whole once, then banded
    bands = mesh.make_mesh(devices=[device] * 2)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            whole = counted("model_axis_swap banded whole f32", lambda: spatial.make_sharded_swap(
                bands, cfg=cfg32, dtype=torch.float32, from_res=512)(zoo32, *trip), at_least=2)
            swap = spatial.make_sharded_swap(bands, cfg=cfg32, dtype=torch.float32,
                                             from_res=512)
            mesh.MOVES.clear()
            got = counted("model_axis_swap banded placed f32", lambda: swap(placed[False], *trip),
                          at_least=2)
            first = moves()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    err, scale = float((got - whole).abs().max()), float(whole.abs().max())
    out["banded"] = {"err": err, "equal": bool(torch.equal(got, whole)), "moves": first,
                     "launches": LAUNCHES["model_axis_swap banded placed f32"]}
    log(f"[model_axis_swap] make_sharded_swap (2 bands of [{device}] * 2, from_res 512) handed "
        f"the (1, 2) model-axis zoo vs the same banded swap on the whole zoo, B=2 f32: max "
        f"|diff| {err:.3e} of max |y| {scale:.4f} (bit-equal {out['banded']['equal']}); moves "
        f"of the first call {first} (one gather of the split leaves, then the bands'); "
        f"dilate_erode launches {out['banded']['launches']}  [{card}]")
    if not err <= 1e-3 * scale or out["banded"]["launches"] != 2 or first.get("gather", 0) < 1:
        raise AssertionError(f"banded swap on the model-axis zoo: |diff| {err} of {scale}, "
                             f"moves {first}, launches {out['banded']['launches']}")
    del zoos, placed, whole, got
    torch.cuda.empty_cache()
    return out


def phase_model_axis_swap(hf, zoo32, device, card: str) -> dict:
    """The whole swap on a model-axis zoo at full width: phase 4's f32 zoo
    (its generator, BiSeNet and shape adaptor by their init laws, as phase
    16's label checks need) placed by shard_params_model_axis on (1, 2) and
    (2, 2) meshes of the one card repeated ([cuda:0] * n: the math, not
    multi-card speed), and pipeline.swap.hair_fast run on it at B=2: every
    model column-parallel (parallel/tensor.py), the glue and the kernel on
    the lead device. f32 at zero noise (TF32 off) against the one-device
    swap within 1e-3 of max |y|, HM_X's hair labels against the one
    device's; the kernel's launches (2 per swap, at shapes phase 3 checked);
    the moves per swap by kind, bf16 the same as f32; bf16 p50 in turns
    beside the unsharded swap (CUDA events), the peak memory of one swap
    above what is resident, and device events, busy time and idle share
    per swap (torch.profiler)."""
    import torch

    from hairfastgan_torch.parallel import mesh
    from hairfastgan_torch.pipeline.swap import hair_fast
    from hairfastgan_torch.scripts import fastpath_agreement
    from hairfastgan_torch.scripts.upload_res_agreement import BISENET_SEED, scaled_bisenet
    from hairfastgan_torch.zoo import cast_zoo

    cfg = hf.cfg
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    size = cfg.stylegan.size
    zoo32 = dict(zoo32, generator=fastpath_agreement.scaled_generator(cfg.stylegan, 0, device),
                 bisenet=scaled_bisenet(BISENET_SEED, device),
                 shape_adaptor=_scaled_shape_adaptor(0, device))
    zoo16 = cast_zoo(zoo32, torch.bfloat16)
    rng = np.random.default_rng(19)
    trip = [torch.from_numpy(rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)).to(device)
            for _ in range(3)]
    plans = {"x".join(map(str, m)): mesh.make_mesh(*m, devices=[device] * (m[0] * m[1]))
             for m in MODEL_AXIS_SWAP_MESHES}

    def moves():
        return {k: v for k, v in mesh.MOVES.items() if v}

    out = {"f32": {}, "moves": {}, "moves_bf16": {}, "launches": {}}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref, ref_inter = hair_fast(zoo32, *trip, cfg=cfg32, dtype=torch.float32,
                                       return_intermediate=True)
            scale = float(ref.abs().max())
            hair = float(ref_inter["HM_X"].mean())
            for name, plan in plans.items():
                tp = mesh.shard_params_model_axis(plan, zoo32)
                mesh.MOVES.clear()
                got, inter = counted(f"model_axis_swap {name} f32", lambda: hair_fast(
                    tp, *trip, cfg=cfg32, dtype=torch.float32, return_intermediate=True),
                    at_least=2)
                err = float((got - ref).abs().max())
                agree = float((inter["HM_X"] == ref_inter["HM_X"]).float().mean())
                out["f32"][name] = (err, agree)
                out["moves"][name] = moves()
                out["launches"][name] = LAUNCHES[f"model_axis_swap {name} f32"]
                log(f"[model_axis_swap] {name} mesh on [{device}] * {plan.devices.size}, B=2 "
                    f"f32 zero noise (TF32 off) vs the one-device swap: max |diff| {err:.3e} of "
                    f"max |y| {scale:.4f} (limit 1e-3 of it); HM_X hair labels agree on "
                    f"{agree:.6f} of the pixels (hair share {hair:.4f}); moves per swap "
                    f"{out['moves'][name]}; dilate_erode launches {out['launches'][name]}  "
                    f"[{card}]")
                if not err <= 1e-3 * scale or agree < 0.999 or out["launches"][name] != 2:
                    raise AssertionError(f"model-axis swap {name}: |diff| {err} of {scale}, "
                                         f"HM_X agreement {agree}, launches "
                                         f"{out['launches'][name]}")
            if not 0.0 < hair < 1.0:
                raise AssertionError(f"the f32 swap's target hair share is {hair}")
            del ref, ref_inter, got, inter, tp
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    t0 = time.perf_counter()
    out["optins"] = _model_axis_optins(zoo32, trip, cfg32, cfg, device, card)
    out["optins_s"] = time.perf_counter() - t0
    log(f"[model_axis_swap] the opt-in, packed and banded cases took {out['optins_s']:.1f} s")

    # bf16 B=2 swaps in turns (order reversed every other round), p50 by
    # CUDA events; peak memory of one swap above what is resident
    swaps = {"unsharded": lambda: hair_fast(zoo16, *trip, cfg=cfg, dtype=torch.bfloat16)}
    for name, plan in plans.items():
        swaps[name] = (lambda tp: lambda: hair_fast(tp, *trip, cfg=cfg, dtype=torch.bfloat16))(
            mesh.shard_params_model_axis(plan, zoo16))
    times = {k: [] for k in swaps}
    peak = {}
    with torch.inference_mode():
        for k, fn in swaps.items():
            mesh.MOVES.clear()
            path = "model_axis_swap" if k == "1x2" else f"model_axis_swap {k} bf16"
            counted(path, fn, at_least=2)
            if LAUNCHES[path] != 2:
                raise AssertionError(f"bf16 {k} swap launched the kernel {LAUNCHES[path]} times")
            if k != "unsharded":
                out["moves_bf16"][k] = moves()
                if out["moves_bf16"][k] != out["moves"][k]:
                    raise AssertionError(f"bf16 {k} swap moves {out['moves_bf16'][k]}, f32 "
                                         f"{out['moves'][k]}: a cast gathered apart from its "
                                         "source")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            fn()
            torch.cuda.synchronize()
            peak[k] = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
        for r in range(8):
            for k in (list(swaps) if r % 2 == 0 else list(swaps)[::-1]):
                times[k].append(cuda_ms(swaps[k], 1))
        prof = {k: _profiled(fn, 1) for k, fn in swaps.items()}
    out["p50"] = {k: statistics.median(v) for k, v in times.items()}
    out["peak_gib"], out["scale"], out["hair"] = peak, scale, hair
    out["events"] = {k: v[0] for k, v in prof.items()}
    out["idle"] = {k: 1.0 - prof[k][1] / out["p50"][k] for k in swaps}
    log(f"[model_axis_swap] hair_fast bf16 B=2 1024^2 p50 of 8 (CUDA events, in turns; one "
        f"card: every position's work runs on it, so this reads the math's cost, not "
        f"multi-card speed): " + ", ".join(
            f"{k} {out['p50'][k]:.2f} ms (min {min(times[k]):.2f}, max {max(times[k]):.2f}; "
            f"peak {peak[k]:.3f} GiB; {prof[k][0]:.0f} device events, busy {prof[k][1]:.2f} "
            f"ms, idle share {out['idle'][k]:.3f})" for k in swaps) + f"; moves per bf16 swap "
        f"{out['moves_bf16']} (the f32 swap's: a cast of a slice is gathered through its "
        f"source); dilate_erode launches per swap {LAUNCHES['model_axis_swap']} (1x2)  "
        f"[{card}]")
    del swaps, zoo16, zoo32
    torch.cuda.empty_cache()
    return out


def _tree_values(tree) -> list:
    """The leaves of a nested dict / list tree, Nones and ints included (a
    split-dims tree), in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_values(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tree_values(v)]
    return [tree]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    from hairfastgan_torch.ops import morphology as M

    device = torch.device("cuda:0")
    card = card_info()
    log(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    so = M.build()
    log(f"[build] {so} in {time.perf_counter() - t0:.1f} s")
    log_file = so.with_suffix(".log")
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        log(f"[{name}] phase took {phase_s[name]} s")
        return out

    max_err = phase("kernel", phase_kernel, device)
    record_shapes()  # every later launch must be at a shape phase 3 checked
    hf, hf32, imgs, launches = phase("main", phase_main, device, card)
    p50, peak, rows = phase("times", phase_times, hf, imgs, device, card)
    phase("breakdown", phase_breakdown, hf, imgs, device, card)
    phase("host", phase_host_steps, hf, imgs, device, card)
    serving = phase("serving", phase_serving, hf, hf32, imgs, device, card)
    ckpt = phase("checkpoint_serve", phase_checkpoint_serve, hf32.zoo, imgs, device, card, p50)
    train = phase("train", phase_train, hf32.zoo, device, card)
    pp = phase("train_pp", phase_train_pp, hf32.zoo, device, card)
    zoo32 = hf32.zoo
    del hf32
    star_ms = phase("star", phase_star, hf, device, card)
    phase("cli", phase_cli, card)
    ev = phase("eval", phase_eval, zoo32, device, card)
    par = phase("parallel", phase_parallel, hf, zoo32, device, card)
    fast = phase("fastpaths", phase_fastpaths, hf, zoo32, imgs, device, card)
    tp = phase("model_axis", phase_model_axis, device, card)
    mas = phase("model_axis_swap", phase_model_axis_swap, hf, zoo32, device, card)
    del zoo32
    unchecked = SEEN - CHECKED
    if unchecked:
        raise AssertionError(f"the kernel ran at shapes phase 3 did not check: {sorted(unchecked)}")
    log(f"[kernel] the run launched the kernel at {len(SEEN)} (shape, dtype, iterations), "
        f"each checked bit for bit in phase 3: {sorted(SEEN)}")

    k_ms, p_ms, _, _ = rows[((3, 256, 256, 1), 5, "bfloat16")]
    kc_ms, pc_ms, _, _ = rows[((1, 1024, 1024, 1), 30, "float32")]
    bound, bound_by = dilate_erode_bound((3, 256, 256, 1), 2, 5)
    bound_c, bound_by_c = dilate_erode_bound((1, 1024, 1024, 1), 4, 30)
    report = {"kernels": [{
        "name": "dilate_erode", "route": "cuda",
        "source": "hairfastgan_torch/csrc/morphology.cu",
        "replaces": "hairfastgan_tpu/ops/pallas_morphology.py:55",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "ms_1024x30": kc_ms, "plain_ms_1024x30": pc_ms, "bound_ms_1024x30": bound_c,
        "bound_by_1024x30": bound_by_c, "launches_by_path": LAUNCHES,
        "launch_keys": [[list(k[0]), k[1], k[2]] for k in sorted(SEEN)]}]}
    log(f"[summary] phase seconds {phase_s}; B=8 {serving['batch8'][0]:.2f} transfers/s; "
        f"composite {serving['composite'][0]:.2f} ms; STAR pass {star_ms:.2f} ms")
    log(f"[summary] card: {card}; swap p50 {p50:.2f} ms; peak {peak:.2f} GiB; zoo file save "
        f"{ckpt['save_s']:.2f} s, load {ckpt['load_s']:.2f} s; /swap request p50 "
        f"{ckpt['request_p50_ms']:.1f} ms")
    log(f"[summary] training, B=2 f32 at 1024^2: blending step p50 {train['blend'][0]:.2f} ms "
        f"(peak {train['blend'][1]:.2f} GiB), rotate pose step p50 {train['rotate'][0]:.2f} ms, "
        f"hair step {train['rotate'][1]:.2f} ms (peak {train['rotate'][2]:.2f} GiB); datagen "
        f"p50 ms, launches: " + ", ".join(f"{k} {v[0]:.2f}, {v[1]}" for k, v in train.items()
                                          if k.startswith("generate")))
    log(f"[summary] PostProcess training, B=2 at 1024^2 with the discriminator: fused step "
        f"f32 p50 {pp['fused'][0]:.2f} ms (peak {pp['fused'][1]:.2f} GiB over "
        f"{pp['fused'][2]:.2f} resident), bf16 {pp['bf16'][0]:.2f} ms ({pp['bf16'][1]:.2f} GiB), "
        f"split {pp['split'][0]:.2f} ms ({pp['split'][1]:.2f} GiB), remat {pp['remat'][0]:.2f} "
        f"ms ({pp['remat'][1]:.2f} GiB); disc step {pp['disc'][0]:.2f} ms, R1 {pp['r1_ms']:.2f} "
        f"ms; busy share {pp['profile'][1] / pp['profile'][2]:.3f}; generate_pp_sample "
        f"{pp['generate_pp_sample'][0]:.2f} ms, {pp['generate_pp_sample'][1]} launches")
    log(f"[summary] eval: InceptionV3 p50 {ev['inception_p50_ms']:.2f} ms per batch of 16 "
        f"1024^2 images; build_pca_model (100,000 samples) {ev['pca_build_s']:.2f} s; host "
        f"Keys resize {ev['resize_step']} step(s) from the device bicubic; upload_res=512 "
        f"agreement Keys {ev['upload_res']['keys']}, LANCZOS {ev['upload_res']['lanczos']}")
    log(f"[summary] parallel ({'distinct cards' if torch.cuda.device_count() > 1 else 'one card repeated'}): "
        f"swap bf16 B=1 p50 {', '.join(f'{k} {v:.2f} ms' for k, v in par['p50'].items())}; "
        f"banded f32 max |diff| n=2 {par['banded'][2]['err']:.2e}, n=4 "
        f"{par['banded'][4]['err']:.2e}; halo=1 {par['halo1'][0]:.3e}; data-parallel "
        f"swap_batch rows {max(par['swap_batch']['rows_f32']):.2e}; blending step d grad "
        f"{par['blend_step'][2]:.2e}; disc step d grad {par['disc_step'][1]:.2e}")
    log(f"[summary] dilate_erode [3,256,256,1] bf16 x5: {k_ms * 1e3:.2f} us vs its bound "
        f"{bound * 1e3:.3f} us ({bound_by}); [1,1024,1024,1] f32 x30: {kc_ms * 1e3:.2f} us vs "
        f"{bound_c * 1e3:.3f} us ({bound_by_c}); no single PyTorch call computes it")
    sw, md = fast["swaps"], fast["modules"]
    log(f"[summary] fastpaths, bf16 B=1 swap p50 in turns (events per swap, idle share): "
        + ", ".join(f"{k} {v['p50']:.2f} ms ({v['events']:.0f}, {v['idle']:.3f})"
                    for k, v in sw.items())
        + "; rotate cuts p50 " + ", ".join(f"{k} {v['p50']:.2f} ms ({v['events']:.0f})"
                                           for k, v in fast["rotate"].items())
        + "; packed modules ms unpacked/packed " + ", ".join(
            f"{k} {v['unpacked_ms']:.3f}/{v['packed_ms']:.3f}" for k, v in md.items())
        + f"; fused up-blur ms two-pass/fused at 512->1024 {fast['fuse_blur'][-1][3]:.4f}/"
        f"{fast['fuse_blur'][-1][4]:.4f}; paired f32 swap |diff| {fast['paired_f32'][1]:.2e}, "
        f"packed {fast['packed_f32'][0]:.2e}; seg512 / pairs6 label agreement "
        f"{fast['agreement']['seg512']['label_agreement']} / "
        f"{fast['agreement']['pairs6']['label_agreement']}")
    log(f"[summary] model_axis (one card repeated): generate bf16 B=2 p50 "
        + ", ".join(f"{k} {v:.2f} ms ({tp['peak_gib'][k]:.3f} GiB)" for k, v in tp["p50"].items())
        + "; f32 render max |diff| " + ", ".join(
            f"{k} {m['errs']['render'][0]:.2e}" for k, m in tp["meshes"].items())
        + f" of max |y| {tp['scale']:.3f}; bf16 mean |diff| " + ", ".join(
            f"{k} {m['bf16_mean']:.3e}" for k, m in tp["meshes"].items())
        + f" (unsharded {tp['bf16_own']:.3e})  [{card}]")
    log(f"[summary] model_axis_swap (one card repeated): hair_fast bf16 B=2 p50 "
        + ", ".join(f"{k} {v:.2f} ms ({mas['peak_gib'][k]:.3f} GiB)"
                    for k, v in mas["p50"].items())
        + "; f32 max |diff| vs one device " + ", ".join(
            f"{k} {e[0]:.2e}" for k, e in mas["f32"].items())
        + f" of max |y| {mas['scale']:.4f}; HM_X agreement " + ", ".join(
            f"{k} {e[1]:.6f}" for k, e in mas["f32"].items())
        + "; moves per swap f32 / bf16 " + ", ".join(
            f"{k} {v} / {mas['moves_bf16'][k]}" for k, v in mas["moves"].items())
        + "; device events / idle share " + ", ".join(
            f"{k} {mas['events'][k]:.0f} / {mas['idle'][k]:.3f}" for k in mas["events"])
        + f"; dilate_erode launches per swap {LAUNCHES['model_axis_swap']}  [{card}]")
    opt = mas["optins"]
    log(f"[summary] model_axis_swap opt-ins on (1, 2), f32 max |diff| vs one device / HM_X "
        f"agreement / all_gathers per swap: " + ", ".join(
            f"{k} {c['err']:.2e} / {c['agree']:.6f} / {c['moves']['all_gather']}"
            for k, c in opt["cases"].items())
        + f" (bf16 moves = f32's); split packed leaves {opt['split_packed']}; banded swap on "
        f"the model-axis zoo vs the whole zoo {opt['banded']['err']:.2e} (bit-equal "
        f"{opt['banded']['equal']}), moves {opt['banded']['moves']}  [{card}]")
    jax_like = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                      or m.startswith("hairfastgan_tpu"))
    if jax_like:
        raise AssertionError(f"JAX or the JAX package was imported: {jax_like[:10]}")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
