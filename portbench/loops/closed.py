"""kind "closed": one client in a closed loop, each request issued when the
previous one's result is on the host.

  entry "swap"        B=1: HairFast.swap(face, shape, color, seed=i,
                      output="uint8", output_res=)
  entry "swap_batch"  B=`batch`: HairFast.swap_batch(faces, shapes, colors,
                      case=, output="uint8") over `stacked_batches` batches
                      stacked in set-up, taken in turn

Every request draws three distinct images of a pool of `pool` seeded
images (portbench/load.make_pool); `cases` (default ["distinct"]) gives the
cases that requests take in turn, request i the case i mod len(cases), with
the roles that the case makes equal given one and the same image object
(load.ROLES), as a caller who sends one photo twice does. The seed picks
the weights and the images; every seed gets the same sizes, cases and
count of requests.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.load import ROLES, Sample, draw, make_pool, triples


class Loop:
    def __init__(self, traffic: Dict, hf, seed: int, device):
        self.t, self.hf, self.seed, self.device = traffic, hf, seed, torch.device(device)
        self.batch = int(traffic.get("batch", 1))
        self.entry = traffic["entry"]
        self.cases = list(traffic.get("cases", ["distinct"]))
        self.out_res = traffic.get("output_res")
        self.records: List[Dict] = []  # per request: t0, t1, transfers, ok, profiled
        self.outputs: List[np.ndarray] = []
        self.inputs: List[tuple] = []  # per request: (face, shape, color) as sent
        self.cases_sent: List[str] = []

    def setup(self) -> None:
        t = self.t
        self.pool = make_pool(self.seed, t["pool"], self.hf.cfg.stylegan.size, t["pool_low_res"],
                              self.device)
        self.plan = triples(self.seed, len(self.pool), t["max_requests"], self.batch)
        if self.entry == "swap_batch":  # the client's arrays, stacked before the window
            self.stacked = [tuple(np.stack([self.pool[i] for i in b[:, j]]) for j in range(3))
                            for b in self.plan[:t["stacked_batches"]]]
        self.hf.warmup(cases=tuple(dict.fromkeys(self.cases)), batch_sizes=(self.batch,),
                       output="uint8", output_res=self.out_res)
        for i in range(t["warm_requests"]):  # the real data path once before the window
            self._request(i)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _images(self, i: int):
        """(case, (face, shape, color)) of request i."""
        case = self.cases[i % len(self.cases)]
        if self.entry == "swap":
            three = [self.pool[k] for k in self.plan[i][0]]
        else:
            three = self.stacked[i % len(self.stacked)]
        return case, tuple(three[r] for r in ROLES[case])

    def _request(self, i: int):
        case, (f, s, c) = self._images(i)
        if self.entry == "swap":
            out = self.hf.swap(f, s, c, seed=i, output="uint8", output_res=self.out_res)
        else:
            out = self.hf.swap_batch(f, s, c, case=case, output="uint8")
        return case, (f, s, c), out

    def window(self, seconds: float, tracer=None, profile_after: int = 2,
               profile_requests: int = 3) -> None:
        self.start = time.perf_counter()
        end = self.start + seconds
        i = 0
        while time.perf_counter() < end:
            if i >= len(self.plan):
                raise RuntimeError(f"traffic plan of {len(self.plan)} requests ran out")
            if tracer is not None:
                tracer.transfer = i
                if i == profile_after:
                    tracer.profile_start()
                if i == profile_after + profile_requests:
                    tracer.profile_stop()
            t0 = time.perf_counter()
            try:
                case, imgs, out = self._request(i)
                ok = True
            except Exception as e:  # counted as failed; the loop goes on
                print(f"request {i} failed: {e!r}", file=sys.stderr)
                case, imgs, out, ok = None, None, None, False
            t1 = time.perf_counter()
            if tracer is not None:
                tracer.profiled(self.batch)
            self.records.append({"t0": t0, "t1": t1, "transfers": self.batch if ok else 0,
                                 "ok": ok, "profiled": tracer is not None and tracer.profiling})
            self.outputs.append(out)
            self.inputs.append(imgs)
            self.cases_sent.append(case)
            i += 1
        if tracer is not None and tracer.profiling:
            tracer.profile_stop()
        self.end = time.perf_counter()

    def samples(self, rng: np.random.Generator, k: int) -> List[Sample]:
        out = []
        same_inputs = (lambda i: i) if self.entry == "swap" else (
            lambda i: (i % len(self.stacked), self.cases[i % len(self.cases)]))
        for i in draw(self.records, rng, k, same_inputs):
            imgs = tuple(np.asarray(a).reshape((self.batch,) + a.shape[-3:])
                         for a in self.inputs[i])
            res = np.asarray(self.outputs[i])
            out.append(Sample(images=imgs, output=res.reshape((self.batch,) + res.shape[-3:]),
                              case=self.cases_sent[i], out_res=self.out_res))
        return out

    def close(self) -> None:
        self.outputs, self.inputs = [], []
