#!/usr/bin/env python3
"""Device-time profile of one bench step, bucketed by Dr-Hook scope name.

Runs the flagship step under jax.profiler with a perfetto trace, then
aggregates GPU-op durations by the named_scope labels that
ecrad_tpu.profiling.traced() attaches (same module:proc names as the
reference's Dr Hook).  Usage:

    python tools/profile_step.py [ncol] [block]
"""

import gzip
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ncol = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    block = int(sys.argv[2]) if len(sys.argv) > 2 else None

    import jax
    import jax.numpy as jnp
    import numpy as np
    import __graft_entry__ as ge

    step, args = ge._build(ncol=ncol, dtype="float32", block_size=block)

    def fn_scalar(seed_offset, a):
        cloud = dict(a[8])
        cloud["iseed"] = cloud["iseed"] + seed_offset
        flux = step(*a[:8], cloud, *a[9:])
        acc = jnp.float32(0.0)
        for leaf in jax.tree_util.tree_leaves(flux):
            acc = acc + jnp.sum(leaf.astype(jnp.float32))
        return acc

    fn = jax.jit(fn_scalar)
    print(float(np.asarray(fn(jnp.int32(0), args))))  # compile+warm

    tmpdir = tempfile.mkdtemp(prefix="ecrad_prof_")
    with jax.profiler.trace(tmpdir, create_perfetto_trace=True):
        for i in range(3):
            float(np.asarray(fn(jnp.int32(i + 1), args)))

    # find the perfetto trace
    trace_path = None
    for root, _, files in os.walk(tmpdir):
        for f in files:
            if f.endswith(".trace.json.gz"):
                trace_path = os.path.join(root, f)
    if trace_path is None:
        print("no perfetto trace found under", tmpdir)
        return
    with gzip.open(trace_path, "rt") as f:
        trace = json.load(f)

    events = trace["traceEvents"]
    # device tracks: the "/device:GPU:N" processes, thread "XLA Ops"
    pid_names = {}
    tid_names = {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                pid_names[e["pid"]] = e["args"].get("name", "")
            if e.get("name") == "thread_name":
                tid_names[(e["pid"], e["tid"])] = e["args"].get("name", "")

    device_pids = {p for p, n in pid_names.items()
                   if "/device:GPU" in n}
    buckets = {}
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        tname = tid_names.get((e["pid"], e["tid"]), "")
        if "XLA Op" not in tname and "Steps" not in tname:
            if "op" not in tname.lower():
                continue
        dur = e.get("dur", 0) / 1e6  # us -> s
        name = e.get("name", "")
        args = e.get("args", {}) or {}
        long_name = args.get("long_name", "") or args.get("tf_op", "") \
            or name
        # bucket by scope label: find "xxx:yyy/" segments
        label = None
        for seg in long_name.split("/"):
            if ":" in seg and not seg.startswith("jit("):
                label = seg
                break
        if label is None:
            label = "(unscoped) " + name.split(".")[0][:48]
        buckets.setdefault(label, [0, 0.0])
        buckets[label][0] += 1
        buckets[label][1] += dur
        total += dur

    rows = sorted(buckets.items(), key=lambda kv: -kv[1][1])
    print(f"\ndevice total: {total:.4f} s over 3 iterations "
          f"=> {total/3:.4f} s/step, ncol={ncol}")
    print(f"{'s/step':>9} {'%':>6} {'#ops':>6}  scope")
    for name, (n, t) in rows[:40]:
        print(f"{t/3:9.4f} {100*t/total:6.2f} {n:6d}  {name}")
    print("trace:", trace_path)


if __name__ == "__main__":
    main()
