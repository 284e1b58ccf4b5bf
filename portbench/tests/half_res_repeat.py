"""A loop of a kind that the benchmark does not have, for the test that a new
kind of traffic is added in new files only (test_portbench_registry.py
copies it to a registry's loops/): one client sends the same photo as face
and color and asks for a half-size answer,
HairFast.swap(face, shape, face, output_res=size/2)."""

import time

from portbench.load import Sample, draw, make_pool


class Loop:
    def __init__(self, traffic, hf, seed, device):
        self.t, self.hf, self.seed, self.device = traffic, hf, seed, device
        self.res = hf.cfg.stylegan.size // 2
        self.records, self.sent = [], []

    def setup(self):
        self.pool = make_pool(self.seed, self.t["pool"], self.hf.cfg.stylegan.size, 8,
                              self.device)
        self.hf.warmup(cases=("face_eq_color",), output="uint8", output_res=self.res)

    def window(self, seconds, tracer=None):
        self.start = time.perf_counter()
        i = 0
        while time.perf_counter() < self.start + seconds:
            f, s = self.pool[i % len(self.pool)], self.pool[(i + 1) % len(self.pool)]
            t0 = time.perf_counter()
            out = self.hf.swap(f, s, f, seed=i, output="uint8", output_res=self.res)
            self.records.append({"t0": t0, "t1": time.perf_counter(), "transfers": 1,
                                 "ok": True, "profiled": False})
            self.sent.append(((f[None], s[None], f[None]), out[None]))
            i += 1
        self.end = time.perf_counter()

    def samples(self, rng, k):
        return [Sample(images=self.sent[i][0], output=self.sent[i][1], case="face_eq_color",
                       entry="pipeline.swap:hair_fast", out_res=self.res)
                for i in draw(self.records, rng, k)]

    def close(self):
        self.sent = []
