"""HTTP server over the port's HairFast API (counterpart of scripts/serve.py).

Endpoints
  GET  /healthz          -> {"status": "ok", "devices": [...], "generator_size": N}
  POST /swap             -> image/png of the transfer
      multipart/form-data fields: face, shape, color (PNG/JPEG bytes)
      query parameters: upload_res=512  ship the encoder inputs at 512^2
                        output_res=512  serve a 512^2 response
                        poisson=1       Poisson-composite the face photo back
                        align=1         FFHQ-align in-the-wild photos first
                        seed=N          draw the noise from seed N

Usage
  python -m hairfastgan_torch.serve --zoo_dir pretrained_models_jax --port 8080 --warmup
  curl -F face=@f.png -F shape=@s.png -F color=@c.png \\
      "localhost:8080/swap?output_res=512" -o out.png

--zoo_dir is loaded as `HairFast` loads its checkpoint_dir (zoo.load_zoo);
--tiny and --micro serve 128^2 random-weight zoos instead. --device defaults
to cuda and raises without a GPU (pass --device cpu for the CPU). --host
defaults to 127.0.0.1.

Swaps run one at a time, in arrival order, on one long-lived worker thread
(the server's `worker`; `--warmup` runs there too): a single GPU runs one
swap at a time anyway, and PyTorch keeps cuDNN's execution plans per
thread, so a swap in a fresh thread would plan every convolution again.
This is the latency tier; batched throughput belongs to
`HairFast.swap_batch` behind a queueing tier. ThreadingHTTPServer keeps the
decode and encode of other requests off the worker. A body over MAX_BODY
bytes gets 413 before it is read; a malformed request or query parameter
gets 400; a failed swap gets 500 with a generic message, its traceback going
to stderr. A 200 carries a Server-Timing header with the milliseconds of
each step by the server's clock: decode (read, multipart split, image
decode), queue (waiting for the worker), swap (hf.swap, result on the host)
and encode (PNG).
"""

from __future__ import annotations

import argparse
import email.parser
import io
import json
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from PIL import Image

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.main import build

MAX_BODY = 64 * 2 ** 20  # bytes of one /swap request body
FIELDS = ("face", "shape", "color")
INT_PARAMS = ("upload_res", "output_res", "poisson", "align", "seed")
# the steps of a /swap request, reported in its Server-Timing header (ms)
TIMED = ("decode", "queue", "swap", "encode")


def _headers(block: bytes):
    """MIME header lines (bytes) -> an email.message.Message of them."""
    return email.parser.HeaderParser().parsestr(block.decode("latin-1") + "\r\n\r\n")


def _next_delimiter(data: bytes, delim: bytes, start: int) -> int:
    """Index of the next delimiter at or after `start`, or -1: `delim` (CRLF
    "--" boundary) followed by "--" or by optional whitespace and CRLF;
    other occurrences of the boundary text are content."""
    at = data.find(delim, start)
    while at >= 0:
        rest = at + len(delim)
        eol = data.find(b"\r\n", rest)
        if data.startswith(b"--", rest) or (eol >= 0 and not data[rest:eol].strip(b" \t")):
            return at
        at = data.find(delim, at + 1)
    return -1


def parse_multipart(content_type: str, body: bytes) -> Dict[str, bytes]:
    """multipart/form-data -> {field name: content bytes}.

    The body is split on its boundary over the raw bytes (RFC 2046 §5.1.1),
    so each part's content comes back byte for byte, whatever it holds (bare
    CRs, boundary-like prefixes); only the header blocks are parsed as MIME
    headers. Raises ValueError on a malformed body."""
    ctype = _headers(f"Content-Type: {content_type}".encode("latin-1"))
    boundary = ctype.get_param("boundary")
    if ctype.get_content_type() != "multipart/form-data" or not boundary:
        raise ValueError("expected multipart/form-data with a boundary")
    delim = b"\r\n--" + str(boundary).encode("latin-1")
    data = b"\r\n" + body  # the first delimiter may open the body
    pos = _next_delimiter(data, delim, 0)
    if pos < 0:
        raise ValueError("no multipart boundary in the body")
    parts: Dict[str, bytes] = {}
    while True:
        pos += len(delim)
        if data.startswith(b"--", pos):  # the close delimiter
            return parts
        start = data.find(b"\r\n", pos) + 2  # after the boundary line
        end = _next_delimiter(data, delim, start)
        if end < 0:
            raise ValueError("unterminated multipart body")
        head, sep, content = data[start:end].partition(b"\r\n\r\n")
        if not data.startswith(b"\r\n", start):  # else no headers: a part without a name
            if not sep:
                raise ValueError("multipart part without a header block")
            name = _headers(head).get_param("name", header="content-disposition")
            if name:
                parts[str(name)] = content
        pos = end


def parse_query(query: str) -> Dict[str, Optional[int]]:
    """The /swap query -> {parameter: int or None}; ValueError on a value
    that is not an integer, or a resolution below 1."""
    q = parse_qs(query)
    out = {}
    for k in INT_PARAMS:
        try:
            out[k] = int(q[k][0]) if k in q else None
        except ValueError:
            raise ValueError(f"query parameter {k}={q[k][0]!r} is not an integer") from None
    for k in ("upload_res", "output_res"):
        if out[k] is not None and out[k] < 1:
            raise ValueError(f"query parameter {k}={out[k]} must be >= 1")
    return out


def device_names(device: torch.device) -> list:
    """The serving device by name, e.g. "cuda:0 (NVIDIA H100 80GB HBM3)"."""
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        return [f"cuda:{index} ({torch.cuda.get_device_name(index)})"]
    return [str(device)]


def make_handler(hf, worker: ThreadPoolExecutor):
    class Handler(BaseHTTPRequestHandler):
        server_version = "hairfast-torch"

        def log_message(self, fmt, *args):  # access log to stderr
            sys.stderr.write("%s - %s\n" % (self.address_string(), fmt % args))

        def _send(self, code: int, body: bytes, ctype: str, headers: Optional[dict] = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok", "devices": device_names(hf.device),
                                 "generator_size": hf.cfg.stylegan.size})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/swap":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                self._json(411, {"error": "a Content-Length is required"})
                return
            if length > MAX_BODY:  # refused before reading; the connection closes
                self.close_connection = True
                self._json(413, {"error": f"body of {length} bytes over the {MAX_BODY}-byte cap"})
                return
            t = [time.perf_counter()]
            try:
                parts = parse_multipart(self.headers.get("Content-Type", ""),
                                        self.rfile.read(length))
                missing = [k for k in FIELDS if not parts.get(k)]
                if missing:
                    self._json(400, {"error": f"missing fields: {missing}"})
                    return
                # uint8 [H,W,3] arrays, which to_image_u8 passes through or
                # resizes natively (a PIL image would take the float route)
                imgs = [np.asarray(Image.open(io.BytesIO(parts[k])).convert("RGB"))
                        for k in FIELDS]
                q = parse_query(url.query)
            except Exception as e:  # the request's bytes: any failure to parse them is its own
                self._json(400, {"error": f"bad request: {e}"})
                return
            t.append(time.perf_counter())

            def swap():
                start = time.perf_counter()
                return start, hf.swap(*imgs, output="uint8", upload_res=q["upload_res"],
                                      output_res=q["output_res"], poisson=bool(q["poisson"]),
                                      align=bool(q["align"]), seed=q["seed"])

            try:
                start, out = worker.submit(swap).result()  # one swap at a time (docstring)
                t += [start, time.perf_counter()]
                buf = io.BytesIO()
                Image.fromarray(out).save(buf, format="PNG")
                t.append(time.perf_counter())
            except Exception:  # the server keeps serving; the details go to its log
                traceback.print_exc(file=sys.stderr)
                self._json(500, {"error": "swap failed"})
                return
            timing = ", ".join(f"{k};dur={(b - a) * 1e3:.3f}" for k, a, b in zip(TIMED, t, t[1:]))
            self._send(200, buf.getvalue(), "image/png", {"Server-Timing": timing})

    return Handler


class SwapServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose requests run their swaps on `worker`, one
    long-lived thread; server_close() also stops the worker."""

    def __init__(self, address, hf):
        self.worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="hairfast-swap")
        super().__init__(address, make_handler(hf, self.worker))

    def server_close(self) -> None:
        super().server_close()
        self.worker.shutdown(wait=True)


def build_server(hf, host: str = "127.0.0.1", port: int = 8080) -> SwapServer:
    """A server of `hf` on host:port (port 0: any free port); call its
    serve_forever() to run it, shutdown() to stop it and server_close() to
    release it."""
    return SwapServer((host, port), hf)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="HairFast HTTP server (PyTorch port)")
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"),
                    help="checkpoint directory (zoo_torch.pt, or the reference's raw layout)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--warmup", action="store_true",
                    help="run one uint8 'distinct' swap before accepting traffic, so that the "
                         "first request does not pay for loading kernels and picking cuDNN "
                         "algorithms")
    ap.add_argument("--tiny", action="store_true", help="128^2 random-weight config")
    ap.add_argument("--micro", action="store_true",
                    help="--tiny with 0.25x trunk widths (the cheapest smoke run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when no GPU is there)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    hf = build(args, HairFastConfig(checkpoint_dir=args.zoo_dir))
    srv = build_server(hf, args.host, args.port)
    if args.warmup:  # on the worker, whose cuDNN plans the requests then reuse
        print("warming up (uint8 'distinct' swap)...", flush=True)
        srv.worker.submit(hf.warmup, cases=("distinct",), output="uint8").result()
    print(f"serving on {args.host}:{srv.server_address[1]} (generator {hf.cfg.stylegan.size}^2, "
          f"{device_names(hf.device)[0]})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
