"""The port's HTTP server (hairfastgan_torch/serve.py) on the CPU, in-process
on ephemeral ports: tests/test_serve.py's requests, the port's PNG against
the JAX server's, the four repairs over scripts/serve.py (uint8 arrays
reach swap, 413 before the body is read, 400 on a malformed query value
with a generic 500, and multipart split over the raw bytes), and the one
worker thread that runs every swap.

Both servers serve the micro zoo (torch_port_util.lively, f32) with its
noise weights zeroed: the two frameworks draw different noise from one
seed, and without noise they compute the same swap. Their PNGs agree
within 1 uint8 step (float parities of 2e-4 of scale, quantized on either
side of a .5); at this seed no value differs.
"""

import dataclasses
import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hairfastgan_tpu.api import HairFast as JaxHairFast
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch import serve
from hairfastgan_torch.api import HairFast
from hairfastgan_torch.params.bridge import bridge_zoo
from scripts.serve import build_server as jax_build_server
from tests.test_serve import _multipart, _png_bytes, _post
from tests.torch_port_util import lively

torch.set_num_threads(2)


def _noise_free(tree):
    def zero(path, v):
        key = getattr(path[-1], "key", None)
        return np.zeros_like(v) if key in ("noise_weight", "noise_var") else v

    return jax.tree_util.tree_map_with_path(zero, tree)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def zoos():
    jz, cfg = init_micro_zoo_fast(0)
    jz = _noise_free(lively(jz))
    return jz, bridge_zoo(jz), dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture(scope="module")
def server(zoos):
    _, tz, cfg = zoos
    hf = HairFast(cfg, zoo=tz, device="cpu")
    srv = serve.build_server(hf, port=0)
    yield _start(srv), hf
    srv.shutdown()
    srv.server_close()


def _swap_fields(seed):
    rng = np.random.RandomState(seed)
    return {k: _png_bytes(rng, 128) for k in ("face", "shape", "color")}


# tests/test_serve.py's four requests


def test_healthz(server):
    base, hf = server
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        d = json.loads(r.read())
    assert d["status"] == "ok" and d["devices"] == ["cpu"]
    assert d["generator_size"] == hf.cfg.stylegan.size


def test_swap_roundtrip_png(server):
    base, hf = server
    body, headers = _multipart(_swap_fields(0))
    with _post(base + "/swap", body, headers) as r:
        assert r.headers["Content-Type"] == "image/png"
        timing = r.headers["Server-Timing"]
        img = Image.open(io.BytesIO(r.read()))
    assert img.size == (128, 128) and np.asarray(img).shape == (128, 128, 3)
    steps = dict(part.split(";dur=") for part in timing.split(", "))
    assert tuple(steps) == serve.TIMED and all(float(v) >= 0 for v in steps.values())


def test_swap_missing_field_400(server):
    base, _ = server
    body, headers = _multipart({"face": _png_bytes(np.random.RandomState(1), 128)})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/swap", body, headers)
    assert e.value.code == 400
    assert "missing" in json.loads(e.value.read())["error"]


def test_swap_bad_image_400(server):
    base, _ = server
    body, headers = _multipart({"face": b"not a png", "shape": b"nope", "color": b"nope"})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/swap", body, headers)
    assert e.value.code == 400


def test_png_matches_jax_server(server, zoos):
    """The same request to both servers: PNGs within 1 uint8 step."""
    jz, _, cfg = zoos
    jsrv = jax_build_server(JaxHairFast(cfg, zoo=jz), port=0)
    jbase = _start(jsrv)
    try:
        body, headers = _multipart(_swap_fields(2))
        pngs = []
        for base in (server[0], jbase):
            with _post(base + "/swap?seed=9", body, headers) as r:
                pngs.append(np.asarray(Image.open(io.BytesIO(r.read()))).astype(np.int16))
        assert pngs[0].shape == pngs[1].shape == (128, 128, 3)
        diff = np.abs(pngs[0] - pngs[1])
        print(f"port vs JAX server PNG: max {diff.max()} step(s), {np.count_nonzero(diff)} of "
              f"{diff.size} values differ")
        assert diff.max() <= 1
    finally:
        jsrv.shutdown()
        jsrv.server_close()


# the repairs over scripts/serve.py


def test_swap_gets_uint8_arrays(server, monkeypatch):
    """Decoded images reach swap as uint8 [H,W,3] arrays, so to_image_u8's
    array path (pass-through, or the native resize) takes them."""
    base, hf = server
    seen = []
    orig = hf.swap

    def spy(*imgs, **kw):
        seen.append(imgs)
        return orig(*imgs, **kw)

    monkeypatch.setattr(hf, "swap", spy)
    body, headers = _multipart(_swap_fields(3))
    with _post(base + "/swap?upload_res=64", body, headers) as r:
        assert r.status == 200
    (imgs,) = seen
    assert all(isinstance(im, np.ndarray) and im.dtype == np.uint8 and im.shape == (128, 128, 3)
               for im in imgs)


def test_swaps_run_on_one_worker_thread(server, monkeypatch):
    """Every swap runs on the server's one long-lived worker thread, not on
    the request's own thread (PyTorch keeps cuDNN plans per thread)."""
    base, hf = server
    threads = []
    orig = hf.swap

    def spy(*imgs, **kw):
        threads.append(threading.current_thread())
        return orig(*imgs, **kw)

    monkeypatch.setattr(hf, "swap", spy)
    body, headers = _multipart(_swap_fields(6))
    for _ in range(2):
        with _post(base + "/swap?output_res=32", body, headers) as r:
            assert r.status == 200
    assert threads[0] is threads[1] and threads[0].name.startswith("hairfast-swap")


def test_oversize_body_413_before_read(server):
    """A Content-Length over the cap is refused without reading the body
    (none is sent: a read would wait until the timeout)."""
    base, _ = server
    conn = http.client.HTTPConnection(base.split("//")[1], timeout=30)
    try:
        conn.putrequest("POST", "/swap")
        conn.putheader("Content-Type", "multipart/form-data; boundary=x")
        conn.putheader("Content-Length", str(serve.MAX_BODY + 1))
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == 413 and "cap" in json.loads(r.read())["error"]
    finally:
        conn.close()


@pytest.mark.parametrize("query", ["upload_res=abc", "seed=1.5", "output_res=0", "poisson=yes"])
def test_malformed_query_400(server, query):
    base, _ = server
    body, headers = _multipart(_swap_fields(4))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/swap?" + query, body, headers)
    assert e.value.code == 400
    assert query.split("=")[0] in json.loads(e.value.read())["error"]


def test_failed_swap_500_is_generic(server, capsys):
    """align=1 without STAR weights or dlib fails inside swap: the client
    gets a generic 500, the server's stderr the traceback."""
    base, _ = server
    body, headers = _multipart(_swap_fields(5))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/swap?align=1", body, headers)
    assert e.value.code == 500 and json.loads(e.value.read()) == {"error": "swap failed"}
    assert "Traceback" in capsys.readouterr().err


def test_multipart_raw_bytes_round_trip():
    """Contents holding bare CRs, CRLFs, a boundary-like prefix and the
    boundary text inside a line come back byte for byte; a truncated body
    and a wrong content type raise ValueError."""
    tricky = (b"\x89PNG\r\x1a\rb\r\n--xXhairfast\r\n--xXhairfastXxY\r--\r\n\r\n"
              b"d--xXhairfastXx\r\n" + bytes(range(256)))
    fields = {"face": tricky, "shape": b"\r", "color": b""}
    body, headers = _multipart(fields)
    assert serve.parse_multipart(headers["Content-Type"], b"preamble\r\n" + body) == fields
    with pytest.raises(ValueError):
        serve.parse_multipart(headers["Content-Type"], body[:-40])
    with pytest.raises(ValueError):
        serve.parse_multipart("application/json", body)


def test_cli_flags():
    args = serve.parser().parse_args([])
    assert (args.host, args.port, args.device, args.warmup) == ("127.0.0.1", 8080, "cuda", False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--micro"])
