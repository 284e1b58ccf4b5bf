"""HairFast public API on PyTorch (counterpart of hairfastgan_tpu/api.py).

`HairFast(cfg, zoo=None, device="cuda")` offers the JAX API's surface:
`swap` (with `align`, `poisson`, `output`, `upload_res`, `output_res`,
`benchmark`, `exp_name`), `swap_tensor` (the same, result left on the
device), `warmup`, `swap_batch` and `swap_stream`; `get_parser` /
`config_from_args` give the CLI's model flags. Images come as paths, PIL
images or uint8 / [0,1] float ndarrays. The zoo is the port's parameter tree
(zoo.load_zoo, zoo.init_zoo, or params/bridge.bridge_zoo of a JAX zoo);
without one, `cfg.checkpoint_dir` is loaded when it exists (zoo.load_zoo:
its zoo_torch.pt, else the reference's raw checkpoints), and a random zoo
is drawn from seed 0 when it does not. With cfg.compute_dtype == "bfloat16"
the zoo is cast to bf16 and every stage computes in bf16. Everything
between the upload and the result's copy to the host (the swap, the Poisson
composite, the output downsample, the uint8 quantization) runs on `device`.
"""

from __future__ import annotations

import argparse
import collections
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
from hairfastgan_torch.data import native_loader
from hairfastgan_torch.ops.resample import bicubic_downsample
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.params.bridge import map_tree
from hairfastgan_torch.pipeline.composite import poisson_composite
from hairfastgan_torch.pipeline.swap import hair_fast, swap_cases
from hairfastgan_torch.utils import face_align, timing
from hairfastgan_torch.utils.images import equal_replacer, save_image01, to_image_u8, to_raw_image
from hairfastgan_torch.utils.save_utils import save_gen_image, save_latents, save_vis_mask
from hairfastgan_torch.zoo import cast_zoo, init_zoo, load_zoo

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
OUTPUTS = ("float32", "uint8")


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """[0,1] image -> uint8, on its device; f32 before the *255 + 0.5, so a
    bf16 image rounds as its f32 value would."""
    return (x.float() * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def chunk_seed(seed: int, start: int) -> int:
    """The noise seed of the swap_batch chunk starting at row `start`."""
    return int(np.random.SeedSequence([seed, start]).generate_state(1)[0])


def _host(*ts: torch.Tensor) -> np.ndarray:
    """Device tensor(s) -> ndarray: uint8 as it is, floats as float32;
    several are concatenated on the device first. The `fetch` span."""
    with timing.span("fetch"):
        t = ts[0] if len(ts) == 1 else torch.cat(ts)
        return (t.float() if t.is_floating_point() else t).cpu().numpy()


class HairFast:
    """Hairstyle transfer interface (reference hair_swap.py:27-105)."""

    def __init__(self, cfg: HairFastConfig = HairFastConfig(), zoo: Optional[Dict] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.compute_dtype]
        if zoo is None and Path(cfg.checkpoint_dir).exists():
            zoo = load_zoo(cfg.checkpoint_dir, cfg, device=self.device)
        elif zoo is None:
            zoo = init_zoo(cfg, seed=0, device=self.device)
        else:
            zoo = map_tree(zoo, lambda _, t: t.to(self.device))
        self.zoo = cast_zoo(zoo, self.dtype) if self.dtype != torch.float32 else zoo
        self.bench = timing.BenchSession("swap")
        self.stream_loader = None  # the decoder the last swap_stream used
        self._replicas = {}  # tuple of mesh devices -> the zoo on each (swap_batch)

    # -- device helpers --------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host_tensor(self, a) -> torch.Tensor:
        """ndarray (or host tensor) -> host tensor, pinned when the device is
        a GPU, so that copies from it queue without blocking the host."""
        if not isinstance(a, torch.Tensor):  # torch wants writable arrays
            a = torch.from_numpy(np.require(a, requirements="CW"))
        return a.pin_memory() if self.device.type == "cuda" else a

    def _to_device(self, a) -> torch.Tensor:
        """ndarray (or host tensor) -> tensor on the device. To a GPU through
        pinned memory without blocking the host, so uploads queue behind
        the batches already launched instead of waiting for them."""
        return self._host_tensor(a).to(self.device, non_blocking=True)

    @timing.span("upload")
    def _upload(self, imgs: Sequence[np.ndarray]):
        """[H,W,3] arrays -> [1,H,W,3] device tensors; the same object
        uploads once (equal images share one tensor)."""
        on_device = {}
        for im in imgs:
            if id(im) not in on_device:
                on_device[id(im)] = self._to_device(im[None])
        return [on_device[id(im)] for im in imgs]

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.cfg.seed if seed is None else seed)
        return g

    def _fetch_async(self, t: torch.Tensor):
        """Queue the copy of `t` into pinned host memory behind the work that
        made it: (host tensor, event to wait on, or None). Waiting on the
        event waits for this result only, not for later launches."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        return host, done

    # -- serving levers --------------------------------------------------

    def _upload_res(self, upload_res: Optional[int]) -> int:
        """Clamp the requested upload resolution to [floor, size]: the floor
        is 512 on full-size configs (BiSeNet parses in a fixed 512^2 space),
        1 on sub-512 generator configs."""
        size = self.cfg.stylegan.size
        if upload_res is None:
            return size
        floor = 512 if size > 512 else 1
        return max(floor, min(upload_res, size))

    def _output_res(self, output_res: Optional[int]) -> int:
        """Snap the requested response resolution up to a power-of-two
        divisor of the generator size (the output downsample is an
        integer-factor bicubic FIR)."""
        size = self.cfg.stylegan.size
        if output_res is None or output_res >= size:
            return size
        if output_res < 1:
            raise ValueError(f"output_res must be >= 1, got {output_res}")
        f = size // output_res
        f = 1 << (f.bit_length() - 1)
        return size // f

    def _downsample(self, final: torch.Tensor, out_res: int) -> torch.Tensor:
        """[B,size,size,3] -> [B,out_res,out_res,3], PULSE bicubic, on the device."""
        size = self.cfg.stylegan.size
        if out_res == size:
            return final
        if size % out_res != 0:
            raise ValueError(f"out_res {out_res} must divide size {size}")
        return bicubic_downsample(final.permute(0, 3, 1, 2), size // out_res).permute(0, 2, 3, 1)

    @timing.span("serve")
    def _serve(self, case: str, face, shape, color, generator, u8: bool,
               out_res: int, zoo: Optional[Dict] = None) -> torch.Tensor:
        """hair_fast plus the response levers, all on the device; `zoo` is
        the inputs' device's copy of the zoo (self.zoo when None)."""
        zoo = self.zoo if zoo is None else zoo
        with torch.inference_mode():
            final = self._downsample(hair_fast(zoo, face, shape, color, case=case,
                                               cfg=self.cfg, dtype=self.dtype,
                                               generator=generator), out_res)
            return quantize_u8(final) if u8 else final

    # -- single swap -----------------------------------------------------

    def _align(self, images) -> list:
        """Photos of any size -> FFHQ-aligned uint8 crops at the generator
        size: STAR on the device when the zoo carries "star", else dlib."""
        crops = face_align.align_faces([to_raw_image(im) for im in images],
                                       output_size=self.cfg.stylegan.size,
                                       star_params=self.zoo.get("star"))
        return [np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8) for c in crops]

    def swap_tensor(self, face_img, shape_img, color_img, benchmark: bool = False,
                    align: bool = False, seed: Optional[int] = None,
                    exp_name: Optional[str] = None, poisson: bool = False,
                    output: str = "float32", upload_res: Optional[int] = None,
                    output_res: Optional[int] = None) -> torch.Tensor:
        """Like `swap`, but returns the [H,W,3] result where it was computed
        (on the device: uint8, or float in the compute dtype, f32 after the
        Poisson composite), without the host copy. A `request` span where no
        request is open on the thread."""
        with timing.request(entry="swap_tensor", rows=1):
            return self._swap_tensor(face_img, shape_img, color_img, benchmark, align, seed,
                                     exp_name, poisson, output, upload_res, output_res)

    def _swap_tensor(self, face_img, shape_img, color_img, benchmark, align, seed, exp_name,
                     poisson, output, upload_res, output_res) -> torch.Tensor:
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
        size = self.cfg.stylegan.size
        up = self._upload_res(upload_res)
        raw = (face_img, shape_img, color_img)
        if align:  # crops from the original pixels, then the upload size
            imgs = self._align(raw)
            face_full = imgs[0]
            if up != size:
                imgs = [to_image_u8(im, up) for im in imgs]
        else:
            imgs = [to_image_u8(im, up) for im in raw]
            face_full = None
        imgs = equal_replacer(imgs)
        case = swap_cases(*imgs)
        timing.annotate(case=case)
        face, shape, color = self._upload(imgs)
        debug = self.cfg.save_all and exp_name is not None
        ores = self._output_res(output_res)

        if benchmark:
            self.bench.start()
        g = self._generator(seed)
        if not (poisson or debug):
            result = self._serve(case, face, shape, color, g, output == "uint8", ores)
        else:  # both need the full-size final image first
            with timing.span("serve"), torch.inference_mode():
                out = hair_fast(self.zoo, face, shape, color, case=case, cfg=self.cfg,
                                dtype=self.dtype, generator=g, return_intermediate=debug)
                final, inter = out if debug else (out, None)
                if poisson:
                    # clones the ORIGINAL face at full resolution; under
                    # upload_res the full-size face ships separately for this pass
                    pface = face if up == size else self._upload(
                        [face_full if face_full is not None else to_image_u8(face_img, size)])[0]
                    final = poisson_composite(self.zoo, final.float(), pface.float() / 255.0)
                    # save_all without poisson keeps the full-size final, as the JAX API
                    final = self._downsample(final, ores)
                result = quantize_u8(final) if output == "uint8" else final
        if benchmark:
            self._sync()
            self.bench.lap()
        if debug:
            self._dump_intermediates(exp_name, final[0], inter)
        return result[0]

    def swap(self, face_img, shape_img, color_img, benchmark: bool = False,
             align: bool = False, seed: Optional[int] = None,
             exp_name: Optional[str] = None, poisson: bool = False,
             output: str = "float32", upload_res: Optional[int] = None,
             output_res: Optional[int] = None) -> np.ndarray:
        """face/shape/color (path | PIL | ndarray) -> [H,W,3] float32 in
        [0,1], or uint8 with output="uint8" (quantized on the device: 4x
        fewer bytes to the host).

        `seed` seeds the fresh noise (cfg.seed when None). upload_res ships
        the inputs at that size (clamped to [512, size] on full-size
        configs); output_res serves the result downsampled to a power-of-two
        divisor of the size; poisson=True seamless-clones the original face
        photo back in outside the dilated hair region (before the output
        downsample); align=True FFHQ-aligns in-the-wild photos first (STAR
        on the device when the zoo has "star", else dlib); benchmark=True
        times the call into self.bench; exp_name with cfg.save_all dumps the
        intermediates under cfg.save_all_dir/exp_name. One `request` span."""
        with timing.request(entry="swap", rows=1):
            out = self.swap_tensor(face_img, shape_img, color_img, benchmark=benchmark,
                                   align=align, seed=seed, exp_name=exp_name, poisson=poisson,
                                   output=output, upload_res=upload_res, output_res=output_res)
            return _host(out)

    __call__ = swap

    def _dump_intermediates(self, exp_name: str, final: torch.Tensor, inter: Dict) -> None:
        """save_all artifact dumps (reference utils/save_utils.py usage)."""
        h = {k: _host(v) for k, v in inter.items()}
        out = Path(self.cfg.save_all_dir) / exp_name
        save_image01(out / "Final" / "final.png", _host(final))
        save_gen_image(out, "Blending", "blending.png", h["I_blend"])
        for name in ("mask_face", "mask_shape", "mask_color"):
            save_vis_mask(out, "Shape", f"{name}.png", h[name])
        save_latents(out, "FS", "face.npz", latent_S=h["S_face"], latent_F=h["F_face"],
                     latent_W=h["W_face"])
        save_latents(out, "Align", "align.npz", latent_F_align=h["latent_F_align"])
        save_latents(out, "Blending", "blending.npz", S_blend=h["S_blend"])
        save_latents(out, "Final", "final.npz", S_final=h["S_final"], F_final=h["F_final"])

    # -- batches and streams ---------------------------------------------

    def warmup(self, cases=("distinct",), batch_sizes=(1,), output: str = "float32",
               upload_res: Optional[int] = None, output_res: Optional[int] = None):
        """One swap of zero images per (case, batch size), so that the first
        request does not pay for loading kernels and picking cuDNN
        algorithms; `output`, `upload_res` and `output_res` as the requests
        will use them."""
        size = self._upload_res(upload_res)
        ores = self._output_res(output_res)
        for b in batch_sizes:
            z = torch.zeros((b, size, size, 3), dtype=torch.uint8, device=self.device)
            for case in cases:
                self._serve(case, z, z, z, self._generator(None), output == "uint8", ores)
        self._sync()
        return self

    def swap_batch(self, faces, shapes, colors, case: str = "distinct",
                   output: str = "float32") -> np.ndarray:
        """Batched triples [B,H,W,3] (uint8 or [0,1] float) -> [B,H,W,3].

        With n > 1 local devices (parallel.mesh.local_devices) and B % n == 0
        the batch is split over a data mesh of all n: each device runs the
        plain B/n-transfer swap on its own copy of the zoo, and nothing
        crosses devices but the inputs' shards and the rows gathered back,
        so each row equals a B=1 `swap` of that triple at zero noise. As in
        the JAX package every shard draws its noise from the same seed,
        chunk_seed(cfg.seed, 0).

        Otherwise the batch runs on the one device, in chunks of
        cfg.max_batch_per_dispatch; the chunk starting at row i draws its
        noise from a generator seeded with chunk_seed(cfg.seed, i), so a
        batch that fits in one chunk draws from chunk_seed(cfg.seed, 0).
        output="uint8" quantizes on the device(s). One `request` span."""
        with timing.request(entry="swap_batch", case=case, rows=len(faces)):
            u8 = output == "uint8"
            b = len(faces)
            size = self.cfg.stylegan.size
            devs = mesh.local_devices(self.device)
            if len(devs) > 1 and b % len(devs) == 0:
                plan = mesh.make_mesh(devices=devs)
                key = tuple(devs)
                if key not in self._replicas:
                    self._replicas[key] = mesh.replicate(plan, self.zoo)
                seed = chunk_seed(self.cfg.seed, 0)

                def shard(zoo, face, shape, color):
                    g = torch.Generator(device=face.device)
                    g.manual_seed(seed)
                    return self._serve(case, face, shape, color, g, u8, size, zoo)

                with timing.span("upload"):
                    host = [self._host_tensor(a) for a in (faces, shapes, colors)]
                out = mesh.data_parallel(plan, shard, (False, True, True, True))(
                    self._replicas[key], *host)
                return _host(out)
            chunk = self.cfg.max_batch_per_dispatch or b
            outs = []
            for i in range(0, b, chunk):
                with timing.span("upload"):
                    part = [self._to_device(a[i:i + chunk]) for a in (faces, shapes, colors)]
                g = self._generator(chunk_seed(self.cfg.seed, i))
                outs.append(self._serve(case, *part, g, u8, size))
            return _host(*outs)

    def swap_stream(self, triples, case: str = "distinct", depth: int = 3,
                    output: str = "float32", batch: int = 1,
                    upload_res: Optional[int] = None, output_res: Optional[int] = None):
        """Serving path: yield (index, image) over (face, shape, color) path
        triples, in order, overlapping host decode with device compute.

        Decoding runs on the native C++ loader's threads, or with PIL where
        that loader is unavailable (data/native_loader.native_error says
        why). Up to `depth` batches of `batch` triples stay in flight on the
        device; the host blocks only on the oldest one, whose copy to the
        host waits for that batch alone;
        `self.stream_loader` names the decoder that ran. A partial
        last group is padded with its last triple, so every launch has one
        shape. Every batch draws its noise as a one-chunk swap_batch does, so
        a group's results are swap_batch's on the padded group. A triple that
        fails to decode yields (index, None), in launch order, and the stream
        goes on. upload_res / output_res as in `swap`. The stream is one
        `request` span, open across the yields.
        """
        with timing.request(entry="swap_stream", case=case, rows=len(triples)):
            up = self._upload_res(upload_res)
            ores = self._output_res(output_res)
            u8 = output == "uint8"
            paths = [p for t in triples for p in t]
            images: Dict[int, np.ndarray] = {}
            loader = None
            self.stream_loader = "native C++" if native_loader.native_available() else "PIL"
            if self.stream_loader == "native C++":
                loader = native_loader.NativeImageLoader(paths, out_size=up, threads=4)
                got = iter(loader)
            else:  # failed decodes are absent from `images`, as with the native loader
                for i, p in enumerate(paths):
                    try:
                        images[i] = to_image_u8(p, up)
                    except Exception as e:
                        warnings.warn(f"decode failed: {p} ({e})")
                got = iter(())

            pending = collections.deque()  # (triple indices, (host, event) or None)
            next_needed, n, drained = 0, len(triples), False

            def ready(i):
                return all(3 * i + j in images for j in range(3))

            def launch(idxs):
                pad = list(idxs) + [idxs[-1]] * (batch - len(idxs))
                with timing.span("upload"):
                    face, shape, color = (
                        self._to_device(np.stack([images[3 * i + j] for i in pad]))
                        for j in range(3))
                for i in idxs:
                    for j in range(3):
                        images.pop(3 * i + j)
                out = self._serve(case, face, shape, color,
                                  self._generator(chunk_seed(self.cfg.seed, 0)), u8, ores)
                with timing.span("fetch"):
                    pending.append((idxs, self._fetch_async(out if u8 else out.float())))

            try:
                while next_needed < n or pending:
                    while next_needed < n and len(pending) < depth:
                        group = list(range(next_needed, min(next_needed + batch, n)))
                        if all(ready(i) for i in group):
                            launch(group)
                            next_needed = group[-1] + 1
                        elif not drained:
                            try:
                                idx, img = next(got)
                                images[idx] = img
                            except StopIteration:
                                drained = True
                        else:  # decode failures in this group: mark them, batch the rest
                            good = [i for i in group if ready(i)]
                            bad = [i for i in group if not ready(i)]
                            for i in bad:
                                missing = [paths[3 * i + j] for j in range(3)
                                           if 3 * i + j not in images]
                                warnings.warn(f"skipping triple {i}: decode failed for {missing}")
                                for j in range(3):
                                    images.pop(3 * i + j, None)
                            pending.append((bad, None))
                            if good:
                                launch(good)
                            next_needed = group[-1] + 1
                    if pending:
                        idxs, fetched = pending.popleft()
                        if fetched is None:
                            for i in idxs:
                                yield i, None
                            continue
                        host, done = fetched
                        with timing.span("fetch"):
                            if done is not None:
                                done.synchronize()
                            host = host.numpy()
                        for j, i in enumerate(idxs):
                            yield i, host[j]
            finally:  # stops the decode threads when the stream ends or is dropped
                if loader is not None:
                    loader.close()


def get_parser() -> argparse.ArgumentParser:
    """The JAX CLI's model flags and defaults (hairfastgan_tpu/api.py
    get_parser), without --compile_cache_dir, which configures XLA's
    compile cache and has no PyTorch counterpart."""
    p = argparse.ArgumentParser(description="HairFast (PyTorch port)")
    p.add_argument("--save_all_dir", type=Path, default=Path("output"))
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--ckpt_dir", type=str, default="pretrained_models_jax",
                   help="checkpoint directory, loaded when it exists (zoo_torch.pt, else the "
                        "reference's raw checkpoints); random weights when it does not")
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--save_all", action="store_true")
    p.add_argument("--mixing", type=float, default=0.95)
    p.add_argument("--smooth", type=int, default=5)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"))
    return p


def config_from_args(args: argparse.Namespace) -> HairFastConfig:
    return HairFastConfig(
        stylegan=StyleGANConfig(size=args.size, channel_multiplier=args.channel_multiplier,
                                style_dim=args.latent, n_mlp=args.n_mlp),
        batch_size=args.batch_size,
        mixing=args.mixing,
        smooth=args.smooth,
        save_all=args.save_all,
        save_all_dir=args.save_all_dir,
        checkpoint_dir=Path(args.ckpt_dir),
        compute_dtype=args.compute_dtype,
    )
