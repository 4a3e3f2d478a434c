"""Card-resident groups: frames made on the card from the seed, cycled through
the port's entry by one client in a closed loop.

Workload parameters: ``call`` (``"module:function"``, called as
``call(group, *args)``; ``result`` picks an item of a tuple it returns),
``group`` (images per call), ``groups`` (distinct groups, cycled), ``keep``
(calls whose outputs are kept for the check, drawn from the seed) and
``stretch`` (calls in a traced run's profiled stretch). A unit is one call
and the synchronize after it: ``call_ms`` is its time on the card's clock,
``mpix`` its input megapixels. The substitute of a control or fault run
takes the entry's output.
"""

from __future__ import annotations

from port_bench import frames, harness, spec


class Traffic:
    def __init__(self, run):
        wl, cfg = run.workload, run.config
        self.run, g = run, int(wl["group"])
        imgs = frames.frames(g * int(wl["groups"]), cfg["height"], cfg["width"], run.seed,
                             run.device)
        self.groups = [imgs[i * g:(i + 1) * g] for i in range(int(wl["groups"]))]
        fn, args, item = spec.entry(wl["call"]), wl.get("args", []), wl.get("result")
        transform = harness.substitute(run)

        def call(group):
            out = fn(group, *args)
            out = out if item is None else out[item]
            return out if transform is None else transform(out, group)

        self.call, self.images = call, g
        self.name = wl["call"].rpartition(":")[2]
        self.mpix = g * cfg["height"] * cfg["width"] / 1e6
        self.kept = harness.Sample(int(wl["keep"]), run.seed)
        self.timer = harness.Timer(run.device)
        for group in self.groups:  # the graph's capture, the kernels' build, the tables
            self.call(group)
        harness.synchronize(run.device)

    def unit(self, k):
        i = (k or 0) % len(self.groups)
        self.timer.start()
        out = self.call(self.groups[i])
        ms = self.timer.stop()
        harness.synchronize(self.run.device)
        if k is not None:
            self.kept.offer(k, (i, out))
        return {"answers": 1, "mpix": self.mpix}, {"call_ms": ms}

    def stages(self, stages):
        pass

    def check(self):
        expected, off = {}, 0
        for i, out in self.kept.items:
            if i not in expected:
                expected[i] = harness.expected(self.run, self.groups[i])
            off += harness.bytes_off(out, expected[i])
        return len(self.kept.items) * self.images, {"bytes_off": off}

    def close(self):
        self.groups = self.kept = None
