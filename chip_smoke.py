"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. the card: nvidia-smi name and power limit, torch's device name
  2. build the hand-written kernel (csrc/morphology.cu) with nvcc
  3. kernel == its plain PyTorch version, bit for bit, on the card
  4. the port's main path: HairFast(HairFastConfig()).swap on three distinct
     seeded 1024^2 images, random full-width zoo in bf16; the kernel's launch
     count over that swap; a zero-noise f32 run; and the slice at 128^2 on
     the card against the same slice on the CPU
  5. times with CUDA events: swap p50 (bf16, B=1), kernel vs plain, peak memory
  6. where the swap's time goes: stage p50 (CUDA events), host enqueue time,
     torch.profiler's device events, busy time and top kernels per swap
The line before the last is the kernel report (JSON); the last line is
{"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def test_masks(shape, seed: int):
    """Random binary masks plus all-zero, all-one, single-pixel and
    border-pixel masks, each [B,H,W,1]."""
    b, h, w, _ = shape
    rng = np.random.default_rng(seed)
    cases = {"random": (rng.random(shape) > 0.5).astype(np.float32),
             "zeros": np.zeros(shape, np.float32), "ones": np.ones(shape, np.float32)}
    pixel = np.zeros(shape, np.float32)
    pixel[:, h // 2, w // 3] = 1
    border = np.zeros(shape, np.float32)
    border[:, 0, 5] = border[:, h - 1, w - 1] = border[:, 7, 0] = 1
    cases.update(pixel=pixel, border=border)
    return cases


def phase_kernel(device) -> float:
    """Kernel vs plain version, exact; returns the max abs error (0.0)."""
    import torch

    from hairfastgan_torch.ops import morphology as M

    worst = 0.0
    n = 0
    shapes = [(3, 256, 256, 1), (1, 256, 256, 1), (2, 37, 300, 1)]  # last: ragged tiles
    for si, shape in enumerate(shapes):
        for name, m in test_masks(shape, seed=si).items():
            for dtype in (torch.float32, torch.bfloat16):
                for iters in (1, 3, 5):
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
                    n += 1
    log(f"[kernel] {n} cases equal bit for bit (shapes {shapes}, f32+bf16, iters 1/3/5)")
    wide = torch.zeros((1, 8, 60000, 1), device=device)  # rows over the shared memory
    try:
        M.dilate_erode(wide, 5)
    except RuntimeError as e:
        log(f"[kernel] too wide a mask raises: {e}")
    else:
        raise AssertionError("the kernel took a [1,8,60000,1] mask")
    x = torch.from_numpy(test_masks((1, 256, 256, 1), seed=5)["random"]).to(device)
    if not all(map(torch.equal, M.dilate_erode(x, 5), M.dilate_erode_reference(x, 5))):
        raise AssertionError("the kernel disagrees after a refused launch")
    return worst


def phase_main(device, card: str):
    import torch

    from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
    from hairfastgan_torch.api import HairFast
    from hairfastgan_torch.ops import morphology as M
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

    M.dilate_erode.launches = 0
    t0 = time.perf_counter()
    out = hf.swap(*imgs, seed=3407)
    first_s = time.perf_counter() - t0
    launches = M.dilate_erode.launches
    log(f"[main] swap (first call, includes cuDNN algorithm picks): {first_s:.2f} s; "
        f"dilate_erode launches during the swap: {launches}")
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
    del hf32, f32, b16

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
    return hf, imgs, launches


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
        f"{statistics.median(host_ms):.2f} ms; peak memory {peak:.2f} GiB  [{card}]")

    rows = {}
    masks = test_masks((3, 256, 256, 1), seed=11)["random"]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(masks).to(device=device, dtype=dtype)
        kern = lambda: M.dilate_erode(x, 5)  # noqa: E731
        plain = lambda: M.dilate_erode_reference(x, 5)  # noqa: E731
        for f in (kern, plain):
            cuda_ms(f, 20)  # warm-up
        p1, k1, k2, p2 = (cuda_ms(f, 200) for f in (plain, kern, kern, plain))
        rows[str(dtype).split(".")[-1]] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[times] dilate_erode [3,256,256,1] {dtype} iters=5, per call with its "
            f"launch overhead: kernel {(k1 + k2) / 2 * 1e3:.1f} us, plain "
            f"{(p1 + p2) / 2 * 1e3:.1f} us (order plain,kernel,kernel,plain: "
            f"{p1*1e3:.1f} {k1*1e3:.1f} {k2*1e3:.1f} {p2*1e3:.1f}); device-only: kernel "
            f"{device_us(kern, 50):.1f} us, plain {device_us(plain, 50):.1f} us  [{card}]")
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

    max_err = phase_kernel(device)
    hf, imgs, launches = phase_main(device, card)
    p50, peak, rows = phase_times(hf, imgs, device, card)
    phase_breakdown(hf, imgs, device, card)

    k_ms, p_ms = rows["bfloat16"]
    report = {"kernels": [{
        "name": "dilate_erode", "route": "cuda",
        "source": "hairfastgan_torch/csrc/morphology.cu",
        "replaces": "hairfastgan_tpu/ops/pallas_morphology.py:55",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}
    log(f"[summary] card: {card}; swap p50 {p50:.2f} ms; peak {peak:.2f} GiB")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
