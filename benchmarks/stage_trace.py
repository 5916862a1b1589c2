"""Device time of the lifting stages and the grid decode scan, from one
jax.profiler trace of a 2048x2048 RGB encode + decode on the GPU.

One encode and one decode through ``frave_tpu.encode``/``decode`` warm
up (compile); a second pair runs under the profiler. The trace is then
reduced to:

  * ``lifting`` (forward lifting + quantize) and ``inverse_lifting``
    (dequantize + inverse lifting): device time of the kernels built
    from ops under those ``jax.named_scope`` names, beside the HBM-bound
    least time (bytes the stage must move / 3.35 TB/s, the H100 SXM
    data-sheet bandwidth);
  * ``rans_scan``: busy device time of the grid decode's scan kernels,
    per scan row, and the idle time between them inside each wave's
    scan (the gap a persistent decode kernel would remove);
  * the traced window's device busy time and idle share.

Kernels are attributed to a scope through the optimized HLO that XLA
dumps (``--xla_dump_to``): a kernel belongs to a scope when an op inside
its fusion carries that scope in its ``op_name``. Prints one JSON line
and writes the top kernels to ``<out>/kernels.json``.

    python benchmarks/stage_trace.py [--out chiprun_out/stage_trace]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SIZE = 2048  # one SIZE x SIZE RGB image (BASELINE.json config 3)
SCOPES = ("inverse_lifting", "lifting", "rans_scan")


def _scope_of_ops(op_names):
    """The first scope (in SCOPES order) that any op name lies under."""
    for scope in SCOPES:  # inverse_lifting before its substring lifting
        if any(f"/{scope}/" in n or n.endswith(f"/{scope}") for n in op_names):
            return scope
    return None


def _kernel_key(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def hlo_scopes(dump_dir: str) -> dict:
    """{(module, kernel): scope} from XLA's optimized-HLO text dumps,
    plus {(None, kernel): scope} where the kernel name alone decides.
    Kernel names are HLO instruction names with '.' and '-' made '_'."""
    scopes: dict = {}
    opname = re.compile(r'op_name="([^"]*)"')
    for path in glob.glob(os.path.join(dump_dir, "*after_optimizations.txt")):
        module = os.path.basename(path).split(".")[1]
        comp_ops: dict = {}
        calls: dict = {}
        own: dict = {}
        comp = None
        with open(path) as f:
            for line in f:
                head = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
                if head and "=" not in line.split("{")[0]:
                    comp = head.group(1)
                    comp_ops[comp] = []
                    continue
                m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
                if not m or comp is None:
                    continue
                ops = opname.findall(line)
                comp_ops[comp].extend(ops)
                own[m.group(1)] = ops
                c = re.search(r"calls=%?([\w.\-]+)", line)
                if c:
                    calls[m.group(1)] = c.group(1)
        for name, ops in own.items():
            scope = _scope_of_ops(list(ops) + comp_ops.get(calls.get(name, ""), []))
            if scope is None:
                continue
            key = _kernel_key(name)
            scopes[(module, key)] = scope
            prev = scopes.get((None, key))
            scopes[(None, key)] = scope if prev in (None, scope) else "ambiguous"
    return scopes


def _module_of(op_name: str):
    """'jit(decode_single)/...' -> 'jit_decode_single'. Kernels replayed
    from a CUDA graph can carry another module's hlo_module stat, so the
    op name, where present, decides."""
    if op_name.startswith("jit(") and ")" in op_name:
        return "jit_" + op_name[4 : op_name.index(")")]
    return None


def device_events(trace_dir: str):
    """(hlo op, hlo module, op name, start_ns, end_ns) of every kernel
    on the GPU planes (copies and memsets left out), and a summary of
    every plane and line."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f"expected one trace file, found {paths}")
    out, planes = [], []
    for plane in ProfileData.from_file(paths[0]).planes:
        lines = []
        is_gpu = plane.name.startswith("/device:GPU")
        for line in plane.lines:
            events = list(line.events)
            lines.append({"line": line.name, "events": len(events)})
            if not is_gpu:
                continue
            for ev in events:
                if ev.name.startswith(("Memcpy", "Memset")):
                    continue
                stats = dict(ev.stats)
                op_name = str(stats.get("name", ""))
                out.append((
                    str(stats.get("hlo_op", ev.name)),
                    _module_of(op_name) or str(stats.get("hlo_module", "")),
                    op_name,
                    ev.start_ns,
                    ev.start_ns + ev.duration_ns,
                ))
        planes.append({"plane": plane.name, "lines": lines[:40]})
    return out, planes


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_scope(op: str, module: str, op_name: str, scopes: dict):
    """A kernel's scope: from its own op name when that carries one,
    else from the ops inside its fusion (hlo_scopes)."""
    scope = _scope_of_ops([op_name])
    if scope is not None:
        return scope
    key = _kernel_key(op)
    return scopes.get((module, key), scopes.get((None, key)))


def reduce_trace(events, scopes: dict, scan_rows: int) -> dict:
    labelled = [
        (kernel_scope(op, mod, name, scopes), s, e)
        for op, mod, name, s, e in events
    ]
    t0 = min(s for _, s, _ in labelled)
    t1 = max(e for _, _, e in labelled)
    busy = _union((s, e) for _, s, e in labelled)
    per_scope = {
        sc: _union((s, e) for k, s, e in labelled if k == sc)
        for sc in SCOPES + ("ambiguous",)
    }
    # idle gaps inside each run of consecutive scan kernels (one run per
    # wave's scan: any other kernel ends the run)
    gap = 0.0
    run = []
    for k, s, e in sorted(labelled, key=lambda x: x[1]) + [(None, 0, 0)]:
        if k == "rans_scan":
            run.append((s, e))
            continue
        if run:
            gap += (max(e for _, e in run) - min(s for s, _ in run)) - _union(run)
            run = []
    return {
        "window_s": (t1 - t0) / 1e9,
        "device_busy_s": busy / 1e9,
        "device_idle_share": 1.0 - busy / (t1 - t0),
        "kernels": len(events),
        "attributed_s": {k: v / 1e9 for k, v in per_scope.items()},
        "scan_rows": scan_rows,
        "scan_busy_per_row_us": per_scope["rans_scan"] / scan_rows / 1e3,
        "scan_idle_gap_per_row_us": gap / scan_rows / 1e3,
    }


def lifting_bytes(channels: int, n_slots: int) -> dict:
    """Least bytes each lifting stage moves: int32 [C, T*N] in and out,
    plus one bool mask (forward) or two (inverse) of [T*N]."""
    plane = 4 * channels * n_slots
    return {"lifting": 2 * plane + n_slots, "inverse_lifting": 2 * plane + 2 * n_slots}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/stage_trace")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dump = tempfile.mkdtemp(prefix="xla_dump_")
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
    ).strip()

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from bench import card_info, make_corpus, require_gpu
    import jax

    # programs loaded from a compile cache leave no HLO dump to read
    jax.config.update("jax_enable_compilation_cache", False)

    import frave_tpu
    from frave_tpu.codec.container import deserialize
    from frave_tpu.codec.pipeline_jax import get_program
    from frave_tpu.fractal.geometry import BASE_FRAC_DEPTH

    devs = require_gpu()
    img = make_corpus(1, SIZE, SIZE, 3, seed=0)[0]
    opts = frave_tpu.EncoderOptions(backend="jax")
    blob = frave_tpu.encode(img, opts)  # warm-up: compile both programs
    peak_encode = devs[0].memory_stats()["peak_bytes_in_use"]
    out = frave_tpu.decode(blob, backend="jax").data
    assert (out == img).all()
    trace_dir = tempfile.mkdtemp(prefix="trace_")
    jax.profiler.start_trace(trace_dir)
    t = time.perf_counter()
    blob = frave_tpu.encode(img, opts)
    out = frave_tpu.decode(blob, backend="jax").data
    wall = time.perf_counter() - t
    jax.profiler.stop_trace()
    assert (out == img).all()

    ci = deserialize(blob)
    prog = get_program(SIZE, SIZE, BASE_FRAC_DEPTH, ci.num_lanes, 3, "grid")
    events, planes = device_events(trace_dir)
    with open(os.path.join(args.out, "planes.json"), "w") as f:
        json.dump(planes, f, indent=1)
    if not events:
        sys.exit(f"no GPU kernel events in the trace; planes: {planes}")
    scopes = hlo_scopes(dump)
    res = reduce_trace(events, scopes, prog.rows)
    res["wall_encode_decode_s"] = wall
    res["peak_bytes_after_encode"] = peak_encode
    res["peak_bytes_after_decode"] = devs[0].memory_stats()["peak_bytes_in_use"]
    least = lifting_bytes(3, prog.n_slots)
    for stage, nbytes in least.items():
        res[f"{stage}_least_s"] = nbytes / HBM_BYTES_PER_S
    res["device_kind"] = devs[0].device_kind
    res["card"] = card_info()
    totals: dict = {}
    for op, mod, name, s, e in events:
        key = (op, mod, kernel_scope(op, mod, name, scopes))
        totals[key] = totals.get(key, 0) + (e - s)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:60]
    with open(os.path.join(args.out, "kernels.json"), "w") as f:
        json.dump(
            [{"kernel": op, "module": mod, "scope": sc, "device_s": v / 1e9}
             for (op, mod, sc), v in top],
            f, indent=1,
        )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
