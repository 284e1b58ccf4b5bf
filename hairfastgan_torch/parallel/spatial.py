"""Spatial (H-band) sharding of one swap over a mesh (counterpart of
hairfastgan_tpu/parallel/spatial.py): the multi-device latency path.

Design: halo-recompute domain decomposition. Each device renders its own
row band of the high-resolution synthesis pairs from the lower-resolution
feature map, slicing its band plus `halo` rows on each side at the band
entry and discarding the contaminated margin afterwards. The band entry is
where maps are smallest, so the margin costs a few percent of the tail's
work and no movement inside the conv stack: a band render moves its entry
rows out (one scatter) and its kept rows back (one gather).

Correctness rests on the translation-locality of the synthesis tail:
modulated 3x3 convs, 4-tap FIR blurs, the zero-noise path and the ToRGB
skips are all row-local, so a band computed from band + 2*halo entry rows
equals the same rows of the full render once `halo` covers the receptive
field's margin (edge bands clamp to the true array edge, so the real zero
padding holds there). tests/test_torch_port_parallel.py holds the equality
and that halo=1 breaks it.

Placement differs from the JAX package's shard_map, which replicates every
stage that is not banded on every chip (replication costs no ICI traffic
there): here those stages run ONCE, on the lead device, and only the band
renders fan out. The port's swap is bound by host enqueue, so replicating
it per device would multiply the host's time by n. The math is the same.

With a band render of entry resolution R_e on n devices, each device runs
about (1/n + 2*halo/R_e) of the tail's work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.models import stylegan2
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.parallel.mesh import (MeshPlan, ModelSharded, make_mesh, move, on,
                                             replicate)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """How to band the high-resolution synthesis pairs across devices.

    devices:  the band devices, band i on devices[i] (a device may repeat);
              devices[0] is the lead, where the rest of the swap runs
    from_res: first pair OUTPUT resolution that gets banded (512 on the full
              config: >= 512^2 activations; tests use 64 so the micro zoo
              exercises the machinery)
    halo:     extra rows sliced on each side of the band at the tail ENTRY
              resolution; must cover the receptive-field contamination of
              the banded pairs (~3 rows per pair at that pair's input
              resolution; 8 covers any <= 3-pair tail with margin)
    gens:     the generator on each distinct band device (Replicas), or
              None when every band device holds the caller's generator
    """

    devices: Tuple[torch.device, ...]
    from_res: int = 512
    halo: int = 8
    gens: Optional[dict] = dataclasses.field(default=None, compare=False)

    @property
    def n(self) -> int:
        return len(self.devices)


def _pair_res(pair: int) -> int:
    return 4 * (2 ** pair)


def _band_slice(x: Tensor, idx: int, band: int, halo: int) -> Tuple[Tensor, int]:
    """Rows [idx*band - halo, idx*band + band + halo) of dim 2 (NCHW H),
    clamped into the array (edge bands keep the true array edge, so the
    zero padding at the boundary holds). Returns (slice, keep_offset):
    keep_offset is where band idx's own rows start inside the slice."""
    h = x.shape[2]
    size = min(h, band + 2 * halo)
    start = min(max(idx * band - halo, 0), h - size)
    return x[:, :, start:start + size], idx * band - start


def sharded_synthesis(sp: SpatialPlan, gen, latent: Tensor, *, start_layer: int = 0,
                      end_layer: int = 8, layer_in: Optional[Tensor] = None, cfg,
                      dtype: torch.dtype = torch.float32, gather: bool = True):
    """Banded replacement for the rgb output of `stylegan2.synthesis_nchw`
    (NCHW, zero noise): pairs below `from_res` run once on the lead device,
    then each band device renders its band + halo rows of the remaining
    pairs, resuming the ToRGB skip chain from the sliced skip.

    gather=True concatenates the bands on the lead device (one gather:
    renders whose consumers are not row-local, BiSeNet and PostProcess);
    False returns the list of kept bands, band i on sp.devices[i] (the
    final render, which the caller finishes per band and assembles). Zero
    noise only: a band would need row-consistent slices of fresh noise.
    """
    last = min(end_layer, cfg.log_size - 2)
    band_pair = next((p for p in range(max(start_layer, 1), last + 1)
                      if _pair_res(p) >= sp.from_res), None)
    noise = stylegan2.make_noise(None, cfg)
    if band_pair is None:  # nothing reaches from_res: the plain render
        rgb = stylegan2.synthesis_nchw(gen, latent, noise=noise, start_layer=start_layer,
                                       end_layer=end_layer, layer_in=layer_in, cfg=cfg,
                                       dtype=dtype)[1]
        return rgb if gather else [rgb]

    if band_pair > start_layer:
        out, skip = stylegan2.synthesis_nchw(gen, latent, noise=noise, start_layer=start_layer,
                                             end_layer=band_pair - 1, layer_in=layer_in,
                                             cfg=cfg, dtype=dtype)
    else:
        out, skip = layer_in.to(dtype), None

    h_in = out.shape[2]
    if h_in % sp.n:
        raise ValueError(f"band entry rows {h_in} not divisible by n={sp.n}")
    band = h_in // sp.n
    slices = [_band_slice(out, idx, band, sp.halo) for idx in range(sp.n)]
    parts = [[x, latent] + ([_band_slice(skip, idx, band, sp.halo)[0]] if skip is not None
                            else []) for idx, (x, _) in enumerate(slices)]
    moved = iter(move([t for p in parts for t in p],
                      [d for d, p in zip(sp.devices, parts) for _ in p], "scatter"))
    kept = []
    for dev, (_, keep), p in zip(sp.devices, slices, parts):
        out_b, lat_b, *skip_b = (next(moved) for _ in p)
        rgb = stylegan2.synthesis_nchw(on(sp.gens, dev) if sp.gens is not None else gen,
                                       lat_b, noise=noise, start_layer=band_pair,
                                       end_layer=end_layer, layer_in=out_b,
                                       skip=skip_b[0] if skip_b else None, cfg=cfg,
                                       dtype=dtype)[1]
        scale = rgb.shape[2] // out_b.shape[2]
        kept.append(rgb[:, :, keep * scale:(keep + band) * scale])
    if gather:
        return mesh.gather(kept, out.device, dim=2)
    return kept


def spatial_plan(plan: MeshPlan, gen=None, *, from_res: int = 512,
                 halo: int = 8) -> SpatialPlan:
    """The SpatialPlan of `plan`'s model axis (its data axis on a 1-D mesh),
    with `gen` replicated onto its distinct devices when it has more than
    one (one broadcast)."""
    devices = tuple(plan.axis_devices(plan.model_axis or plan.data_axis))
    gens = None
    if gen is not None and len(set(devices)) > 1:
        gens = replicate(make_mesh(devices=devices), gen)
    return SpatialPlan(devices=devices, from_res=from_res, halo=halo, gens=gens)


def make_sharded_swap(plan: MeshPlan, *, case: str = "distinct",
                      cfg: HairFastConfig = HairFastConfig(),
                      dtype: torch.dtype = torch.float32, from_res: int = 512,
                      halo: int = 8):
    """ONE composed swap with its >= from_res renders H-banded over the
    mesh's model axis (data axis on a 1-D mesh):

        swap = make_sharded_swap(plan, cfg=cfg); final = swap(zoo, face, shape, color)

    The zoo and the images are on the lead device, where the result is
    returned (NHWC [B,H,W,3] in [0,1]). Moves for case='distinct': 4
    scatters (one per band render: two rotate renders, I_blend, the final
    render), 3 gathers (the two rotate renders the re-segmentation reads and
    the I_blend PostProcess reads) and 1 more gather that assembles the
    final image's bands; plus, on a mesh of distinct devices, one broadcast
    of the generator on the first call with a zoo.

    A zoo placed over a model axis (mesh.shard_params_model_axis) is
    gathered whole on the lead device on the first call with it (one
    `gather` of its split leaves: mesh.whole_params), as the JAX package's
    shard_map gathers it through its replicated in_specs; the banded swap
    then runs on the whole zoo.
    """
    from hairfastgan_torch.pipeline.swap import hair_fast

    cache: dict = {}

    def swap(zoo, face: Tensor, shape: Tensor, color: Tensor) -> Tensor:
        if isinstance(zoo, ModelSharded):
            if cache.get("placed") is not zoo:
                cache.update(placed=zoo, whole=mesh.whole_params(zoo))
            zoo = cache["whole"]
        gen = zoo["generator"]
        if cache.get("gen") is not gen:
            cache.update(gen=gen, sp=spatial_plan(plan, gen, from_res=from_res, halo=halo))
        return hair_fast(zoo, face, shape, color, case=case, cfg=cfg, dtype=dtype,
                         sp=cache["sp"])

    return swap
