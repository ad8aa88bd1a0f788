"""Reading a ``torch.profiler`` trace of the window.

``busy_s`` is the union of the intervals in which a kernel, copy or set
ran on each card, averaged over the cards the run uses; ``window_s`` the
window's wall time.  ``device_ops`` are the kernels that took most
device time; ``idle_gaps`` the time in which no card ran anything,
summed by what the host was doing at the gap's middle: the innermost
torch operation or CUDA runtime call that the profiler recorded there on
any thread, or ``python`` where none was.
"""

from __future__ import annotations

import heapq
from collections import defaultdict


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _events(prof):
    """(device intervals by card, CPU intervals, device time by name) in
    ns, from the profiler's raw Kineto events: every activity CUPTI
    recorded, launched from any thread, kernels replayed from CUDA graphs
    among them."""
    from torch.autograd import DeviceType

    dev_iv = defaultdict(list)
    cpu = []
    by_name = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if t <= s:
            continue
        if e.device_type() == DeviceType.CUDA:
            dev_iv[e.device_index()].append((s, t))
            by_name[e.name()] += (t - s) / 1e9
        elif e.device_type() == DeviceType.CPU:
            cpu.append((s, t, e.name()))
    return dev_iv, cpu, by_name


def summarize(prof, window_s: float, n_cards: int, top: int = 10) -> dict:
    dev_iv, cpu, by_name = _events(prof)
    merged = {d: _union(iv) for d, iv in dev_iv.items()}
    busy = [sum(e - s for s, e in iv) / 1e9 for iv in merged.values()]
    busy_s = sum(busy) / max(n_cards, 1) if busy else 0.0
    gaps = defaultdict(float)
    allv = _union([tuple(x) for iv in merged.values() for x in iv])
    # sweep the gaps' middles in order over the CPU events by start: the
    # heap's top is the latest-starting event begun before the middle;
    # one that ended before it can cover no later middle either
    cpu.sort()
    heap: list = []
    j = 0
    for (_s0, e0), (s1, _e1) in zip(allv, allv[1:]):
        mid = (e0 + s1) / 2
        while j < len(cpu) and cpu[j][0] <= mid:
            heapq.heappush(heap, (-cpu[j][0], cpu[j][1], cpu[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        gaps[heap[0][2] if heap else "python"] += (s1 - e0) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": window_s,
            "busy_s_by_card": {str(d): b for d, b in zip(merged, busy)},
            "device_ops": [[n[:96], s] for n, s in ops],
            "idle_gaps": [[n[:96], s] for n, s in idle]}
