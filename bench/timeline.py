"""A profiler trace as intervals: what ran on the device, the harness's
spans and the host's operators, on one clock (seconds)."""
import bisect
import json

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals inside [lo, hi]."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The ``(start, end)`` stretches of [lo, hi] no interval covers."""
    out, reach = [], lo
    for a, b in sorted(intervals):
        if a > reach and a < hi:
            out.append((reach, min(a, hi)))
        reach = max(reach, b)
    if reach < hi:
        out.append((reach, hi))
    return out


class Timeline:
    """``device``: ``(start, end, name, category)`` of every kernel, copy
    and set;
    ``spans``: the harness's ``record_function`` spans by name;
    ``host_ops``: ``(start, end, name)`` of the host's operators."""

    def __init__(self, events: list):
        self.device, self.host_ops, self.spans = [], [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            iv = (a, a + float(e["dur"]) * 1e-6, e.get("name", ""))
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append(iv + (cat,))
            elif cat == "user_annotation":
                self.spans.setdefault(iv[2], []).append(iv[:2])
            elif cat == "cpu_op":
                self.host_ops.append(iv)
        self.device.sort()
        self._starts = [iv[0] for iv in self.device]
        self._longest = max((iv[1] - iv[0] for iv in self.device),
                            default=0.0)
        for v in self.spans.values():
            v.sort()

    @classmethod
    def from_file(cls, path) -> "Timeline":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def kernels_in(self, a: float, b: float) -> list:
        """Device intervals that start inside [a, b]."""
        return self.device[bisect.bisect_left(self._starts, a):
                           bisect.bisect_right(self._starts, b)]

    def busy(self, a: float, b: float) -> float:
        """Seconds of [a, b] in which the device ran something."""
        near = self.device[bisect.bisect_left(self._starts,
                                              a - self._longest):
                           bisect.bisect_right(self._starts, b)]
        return union([iv[:2] for iv in near], a, b)

    def label(self, t: float, spans: tuple) -> str:
        """What the host was doing at ``t``: the harness span it was in and
        its innermost operator there."""
        where = "between feeds"
        for name in spans:
            if any(a <= t <= b for a, b in self.spans.get(name, [])):
                where = name
                break
        ops = [iv for iv in self.host_ops if iv[0] <= t <= iv[1]]
        inner = min(ops, key=lambda iv: iv[1] - iv[0])[2] if ops else "host"
        return f"{where}: {inner}"

    def breakdown(self, a: float, b: float, spans: tuple, n: int = 10):
        """The ``n`` device operations that took most time in [a, b], and
        the ``n`` longest stretches in which the device was idle, each
        labelled by what the host was doing at its middle."""
        by_name = {}
        for s, e, name, _ in self.kernels_in(a, b):
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:n]
        idle = sorted(gaps([iv[:2] for iv in self.device], a, b),
                      key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.label((s + e) / 2, spans), e - s]
                              for s, e in idle]}
