"""FFHQ face alignment of in-the-wild photos (counterpart of
hairfastgan_tpu/utils/face_align.py).

The reference uses dlib's 68-landmark detector and a quad crop
(utils/shape_predictor.py:49-194, scripts/align_face.py). Two landmark
providers drive the same FFHQ quad geometry here:

  * dlib on the host (optional dependency), the reference's recipe;
  * the STAR landmark model (models/star.py, WFLW 98 points) on the
    weights' device. STAR has no face detector, so it runs coarse to fine:
    one pass on the whole photo resized to 256^2, then a pass on a square
    crop around the coarse landmarks. Two gates raise `AlignmentError`
    instead of mis-cropping: diffuse heatmaps (mean radial spread over
    `max_spread`) and refine landmarks far from the coarse ones.

The crop reproduces the full FFHQ recipe (shape_predictor.py:146-186):
eye/mouth landmarks -> oriented quad -> shrink oversized photos -> crop to
quad + border -> reflection-pad with a gaussian-blur and median fade where
the quad leaves the frame -> PIL QUAD transform to 4x -> LANCZOS down.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hairfastgan_torch.models.star import star_landmarks_nchw
from hairfastgan_torch.ops.resample import resize


class AlignmentError(ValueError):
    """A landmark pass failed a sanity check (off-center face, no face,
    diffuse heatmaps). Raised instead of silently mis-cropping."""


def _quad_from_features(eye_left: np.ndarray, eye_right: np.ndarray,
                        mouth_left: np.ndarray, mouth_right: np.ndarray):
    """FFHQ oriented quad from eye centers and mouth corners
    (reference utils/shape_predictor.py:96-115)."""
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (mouth_left + mouth_right) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, np.hypot(*x) * 2


def _ffhq_quad(lm: np.ndarray):
    """dlib 68-landmark array -> (quad [4,2], qsize)."""
    return _quad_from_features(lm[36:42].mean(0), lm[42:48].mean(0), lm[48], lm[54])


def _ffhq_quad_wflw(lm: np.ndarray):
    """WFLW 98-landmark array -> (quad [4,2], qsize). Eye rings 60:68 and
    68:76, outer-mouth corners 76 and 82 (models/star.py WFLW_EDGE_INFO);
    ordered by x so that left/right conventions cannot flip the quad."""
    eyes = sorted([lm[60:68].mean(0), lm[68:76].mean(0)], key=lambda p: p[0])
    mouth = sorted([lm[76], lm[82]], key=lambda p: p[0])
    return _quad_from_features(eyes[0], eyes[1], mouth[0], mouth[1])


def _warp_quad(u8: np.ndarray, quad: np.ndarray, qsize: float, output_size: int,
               enable_padding: bool = True) -> np.ndarray:
    """The FFHQ crop of reference utils/shape_predictor.py:146-186 (the
    NVlabs ffhq-dataset recipe) on numpy arrays, with PIL where the
    reference uses it. Returns [output_size, output_size, 3] float in [0,1]."""
    from PIL import Image

    quad = np.array(quad, np.float64)
    pil = Image.fromarray(u8)

    # shrink: oversized photos are antialias-downsampled so that the 4x
    # transform never samples a >2x oversampled source (:146-151)
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(pil.size[0] / shrink)), int(np.rint(pil.size[1] / shrink)))
        pil = pil.resize(rsize, Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # crop to the quad's bounding box plus a border (:153-161)
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, pil.size[0]), min(crop[3] + border, pil.size[1]))
    if crop[2] - crop[0] < pil.size[0] or crop[3] - crop[1] < pil.size[1]:
        pil = pil.crop(crop)
        quad -= crop[0:2]

    # pad: where the quad leaves the frame, reflection-pad and fade the band
    # through a gaussian blur into the median color (:163-179)
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - pil.size[0] + border, 0), max(pad[3] - pil.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        import scipy.ndimage

        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        img = np.pad(np.float32(pil), ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = img.shape
        y, x, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(x) / pad[0], np.float32(w - 1 - x) / pad[2]),
            1.0 - np.minimum(np.float32(y) / pad[1], np.float32(h - 1 - y) / pad[3]))
        blur = qsize * 0.02
        img += (scipy.ndimage.gaussian_filter(img, [blur, blur, 0]) - img) * \
            np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        img += (np.median(img, axis=(0, 1)) - img) * np.clip(mask, 0.0, 1.0)
        pil = Image.fromarray(np.uint8(np.clip(np.rint(img), 0, 255)), "RGB")
        quad += pad[:2]

    # transform: QUAD warp to 4x, LANCZOS down (:181-185)
    transform_size = output_size * 4
    pil = pil.transform((transform_size, transform_size), Image.QUAD, (quad + 0.5).flatten(),
                        Image.BILINEAR)
    pil = pil.resize((output_size, output_size), Image.LANCZOS)
    return np.asarray(pil).astype(np.float32) / 255.0


def star_landmark_provider(star_params: Dict, n_points: int = 98, refine: bool = True,
                           check: bool = True,
                           max_spread: float = 0.45) -> Callable[[np.ndarray], np.ndarray]:
    """[H,W,3] float [0,1] photo -> [n_points, 2] pixel coords (x, y) in its
    frame, from STAR on the weights' device.

    The coarse pass runs on the whole photo (assumed roughly face-centered,
    as portraits are); the refine pass on a square crop spanning 2x the
    coarse landmarks' extent (STAR's training crops frame the face so).
    Each pass resizes its image to 256^2 bilinearly on the device and runs
    STAR there in f32. With `check`, a pass whose fused heatmaps are diffuse
    (mean radial spread over `max_spread`: a trained peak measures about
    0.1, a faceless response about 0.8, in [-1,1] units) and refine
    landmarks whose median displacement from the coarse ones exceeds half
    the coarse extent raise `AlignmentError`.
    """
    device = star_params["e2h_w"].device

    def run_256(img01: np.ndarray):
        x = torch.from_numpy(np.asarray(img01, np.float32)).to(device).permute(2, 0, 1)[None]
        with torch.inference_mode():
            lm, spread = star_landmarks_nchw(star_params, resize(x, (256, 256), "bilinear")
                                             * 2.0 - 1.0, with_spread=True)
        return ((lm[0, :n_points].cpu().numpy().astype(np.float64) + 1.0) / 2.0,
                float(spread[0, :n_points].mean()))

    def checked(img01: np.ndarray, where: str) -> np.ndarray:
        lm, spread = run_256(img01)
        if check and spread > max_spread:
            raise AlignmentError(
                f"{where} STAR pass: diffuse landmark heatmaps (radial spread {spread:.2f} > "
                f"{max_spread:.2f}) — no confident face. The detector-free STAR path assumes "
                "a roughly face-centered portrait; pre-crop the photo, pass aligned crops "
                "with align=False, or install dlib for detection.")
        return lm

    def fn(img01: np.ndarray) -> np.ndarray:
        h, w = img01.shape[:2]
        lm = checked(img01, "coarse") * [w, h]
        if not refine:
            return lm
        c = (lm.min(0) + lm.max(0)) / 2.0
        extent = float((lm.max(0) - lm.min(0)).max())
        half = max(extent, 8.0)  # 2x extent
        x0, y0 = int(round(c[0] - half)), int(round(c[1] - half))
        x1, y1 = int(round(c[0] + half)), int(round(c[1] + half))
        pad = max(0, -x0, -y0, x1 - w, y1 - h)
        src = np.pad(img01, ((pad, pad), (pad, pad), (0, 0)), "reflect") if pad else img01
        crop = src[y0 + pad:y1 + pad, x0 + pad:x1 + pad]
        if min(crop.shape[:2]) < 2:
            return lm
        fine = checked(crop, "refine") * [crop.shape[1], crop.shape[0]] + [x0, y0]
        if check:
            disp = float(np.median(np.linalg.norm(fine - lm, axis=1)))
            if disp > 0.5 * max(extent, 8.0):
                raise AlignmentError(
                    f"STAR coarse/refine passes disagree (median landmark displacement "
                    f"{disp:.1f}px vs extent {extent:.1f}px) — likely an off-center or "
                    "multi-face photo; pre-crop it or pass aligned crops with align=False.")
        return fine

    return fn


def _dlib_landmark_fn() -> Callable[[np.ndarray], np.ndarray]:
    import dlib

    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor("pretrained_models_jax/shape_predictor_68_face_landmarks.dat")

    def fn(img01: np.ndarray) -> np.ndarray:
        u8 = (np.asarray(img01) * 255).astype(np.uint8)
        dets = detector(u8, 1)
        if not dets:
            raise AlignmentError("dlib detected no face")
        shape = predictor(u8, dets[0])
        return np.array([[pt.x, pt.y] for pt in shape.parts()], np.float64)

    return fn


def align_faces(images: List[np.ndarray], output_size: int = 1024,
                star_params: Optional[Dict] = None) -> List[np.ndarray]:
    """[H,W,3] float [0,1] photos of any size (not resized first: the quad
    crops from the original pixels) -> aligned [output_size, output_size, 3]
    crops in [0,1]: STAR landmarks on the weights' device when `star_params`
    is given, else dlib; raises with guidance when neither is there."""
    if star_params is not None:
        landmark_fn, quad_of = star_landmark_provider(star_params), _ffhq_quad_wflw
    else:
        try:
            landmark_fn, quad_of = _dlib_landmark_fn(), _ffhq_quad
        except ImportError as e:
            raise RuntimeError(
                "face alignment needs a landmark provider: install dlib (with "
                "shape_predictor_68_face_landmarks.dat), or place the STAR checkpoint "
                "(star_wflw.pth) in the checkpoint directory for the on-device path, or "
                "pass pre-aligned FFHQ-style crops with align=False") from e
    out = []
    for img in images:
        img = np.asarray(img, np.float32)
        quad, qsize = quad_of(np.asarray(landmark_fn(img), np.float64))
        u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        out.append(_warp_quad(u8, quad, qsize, output_size))
    return out
