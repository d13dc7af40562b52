#!/usr/bin/env python3
"""Profile one bench step on the GPU and summarize op durations.

Writes a jax.profiler trace, then parses the perfetto trace JSON to sum
device-op durations grouped by (fusion) op name, printing the top-N.
Usage: python tools/profile_bench.py [ncol] [block]
"""

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ncol = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 2048

    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as ge

    step, args = ge._build(ncol=ncol, dtype="float32",
                           block_size=block if ncol > block else None)

    def fn_scalar(seed_offset, a):
        cloud = dict(a[8])
        cloud["iseed"] = cloud["iseed"] + seed_offset
        flux = step(*a[:8], cloud, *a[9:])
        acc = jnp.float32(0.0)
        for leaf in jax.tree_util.tree_leaves(flux):
            acc = acc + jnp.sum(leaf.astype(jnp.float32))
        return acc

    fn = jax.jit(fn_scalar)
    print("compiling...", flush=True)
    float(np.asarray(fn(jnp.int32(0), args)))
    print("warm; tracing...", flush=True)

    trace_dir = "/tmp/ecrad_trace"
    os.system(f"rm -rf {trace_dir}")
    with jax.profiler.trace(trace_dir):
        for i in range(2):
            float(np.asarray(fn(jnp.int32(i + 1), args)))

    # find the trace json
    paths = glob.glob(
        f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not paths:
        print("no trace found under", trace_dir)
        return
    with gzip.open(paths[0], "rt") as f:
        trace = json.load(f)

    # device-side events: the "/device:GPU:N" processes, thread "XLA Ops"
    pid_name = {}
    tid_name = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                pid_name[ev["pid"]] = ev["args"].get("name", "")
            if ev.get("name") == "thread_name":
                tid_name[(ev["pid"], ev.get("tid"))] = \
                    ev["args"].get("name", "")

    dur_by_name = defaultdict(float)
    cnt_by_name = defaultdict(int)
    total = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        pname = pid_name.get(ev.get("pid"), "")
        tname = tid_name.get((ev.get("pid"), ev.get("tid")), "")
        if "/device:GPU" not in pname or "XLA Ops" not in tname:
            continue
        d = ev.get("dur", 0) / 1e3  # ms
        name = ev.get("name", "?")
        dur_by_name[name] += d
        cnt_by_name[name] += 1
        total += d

    print(f"\ntotal device op time: {total:.1f} ms (2 steps)")
    items = sorted(dur_by_name.items(), key=lambda kv: -kv[1])
    print(f"{'ms':>9} {'cnt':>5}  name")
    for name, d in items[:60]:
        print(f"{d:9.2f} {cnt_by_name[name]:5d}  {name[:110]}")


if __name__ == "__main__":
    main()
