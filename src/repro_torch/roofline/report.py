"""Roofline report builder: reads the dry-run JSON records of
``launch.dryrun`` and emits the roofline table, in the JAX package's
``roofline.report`` format.

    PYTHONPATH=src python -m repro_torch.roofline.report --dir artifacts/dryrun
    PYTHONPATH=src python -m repro_torch.roofline.report --dir artifacts/dryrun \\
        --mesh multi --write-into PERF.md --marker ROOFLINE_TABLE_MULTI
    PYTHONPATH=src python -m repro_torch.roofline.report --dir artifacts/dryrun \\
        --table status --write-into PERF.md --marker ROOFLINE_STATUS
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs.base import SHAPES
from repro_torch.models import registry
from repro_torch.roofline import analysis

ADVICE = {
    "compute": ("compute-bound: raise MFU via larger per-chip tiles "
                "(less model-parallel splitting) or reduce remat recompute"),
    "memory": ("HBM-bound: fuse/eliminate activation round-trips, widen "
               "arithmetic intensity (bigger microbatches, bf16 workspace)"),
    "collective": ("collective-bound: reshard to cut all-gathers "
                   "(FSDP prefetch overlap, expert-parallel all-to-all "
                   "scheduling, 1D-ring friendly layouts)"),
}


def load_records(d: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_rows(recs: list[dict], mesh: str = "single") -> list[dict]:
    rows = []
    for rec in recs:
        if rec.get("mesh") != mesh:
            continue
        arch, shape_name = rec["arch"], rec["shape"]
        if rec.get("status") == "skipped":
            rows.append({"arch": arch, "shape": shape_name,
                         "skip": rec.get("reason", "skipped")})
            continue
        if rec.get("status") != "ok":
            rows.append({"arch": arch, "shape": shape_name,
                         "skip": f"FAILED: {rec.get('error')}"})
            continue
        cfg = registry.load_arch(arch)
        shape = SHAPES[shape_name]
        mf = analysis.model_flops(cfg, shape)
        rl = analysis.roofline_from_record(rec, mf)
        bound_s = max(rl.compute_s, rl.memory_s, rl.collective_s)
        rows.append({
            "arch": arch, "shape": shape_name,
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "bottleneck": rl.bottleneck,
            "model_flops": mf, "hlo_flops": rl.hlo_flops,
            "useful_ratio": rl.useful_ratio,
            # fraction of the bound the useful math occupies: how close the
            # *useful* work is to the roofline of the dominant resource
            "roofline_fraction": (mf / rec["devices"] / analysis.PEAK_FLOPS)
            / bound_s if bound_s else 0.0,
            "mem_gb": rec.get("memory", {}).get("total_bytes_per_device",
                                                0) / 1e9,
            "devices": rec["devices"],
        })
    return rows


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute | memory | collective | bound | "
           "MODEL/HLO flops | roofline frac | mem/dev |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skip | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.1%} | {r['mem_gb']:.1f} GB |")
    return "\n".join(lines)


def status_table(recs: list[dict]) -> str:
    """Each cell's status and ``compile_s`` (the counted step's seconds,
    planning included), a row an arch, a column a shape: "single /
    multi"."""
    by = {(r["arch"], r["shape"], r.get("mesh")): r for r in recs}
    archs = [a for a in registry.ARCH_IDS if any(r["arch"] == a
                                                  for r in recs)]
    shapes = [s for s in SHAPES if any(r["shape"] == s for r in recs)]

    def one(rec):
        if rec is None:
            return "—"
        if rec.get("status") == "ok":
            return f"ok {rec.get('compile_s')} s"
        return rec.get("status", "?")

    lines = ["| arch | " + " | ".join(shapes) + " |",
             "|---|" + "---|" * len(shapes)]
    for arch in archs:
        cells = [f"{one(by.get((arch, s, 'single')))} / "
                 f"{one(by.get((arch, s, 'multi')))}" for s in shapes]
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def write_marker(md_path: str, marker: str, content: str):
    """Replace '<!-- MARKER -->' (and any previously-inserted table after
    it, up to the next blank-line+non-table text) with the marker + table."""
    with open(md_path) as f:
        text = f.read()
    tag = f"<!-- {marker} -->"
    if tag not in text:
        raise SystemExit(f"marker {tag} not found in {md_path}")
    head, rest = text.split(tag, 1)
    # drop an existing table directly following the marker
    lines = rest.splitlines()
    i = 0
    while i < len(lines) and (not lines[i].strip() or
                              lines[i].lstrip().startswith("|")):
        i += 1
    rest = "\n".join(lines[i:])
    with open(md_path, "w") as f:
        f.write(head + tag + "\n\n" + content + "\n\n" + rest)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--write-into", default="")
    ap.add_argument("--marker", default="BASELINE_TABLE")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "status"],
                    help="the roofline terms of --mesh, or every cell's "
                         "status and compile_s on both meshes")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    rows = roofline_rows(recs, args.mesh)
    table = (markdown_table(rows) if args.table == "roofline"
             else status_table(recs))
    if args.write_into:
        write_marker(args.write_into, args.marker, table)
        print(f"wrote the {args.table} table into {args.write_into}")
        return
    print(table)
    if args.table == "status":
        return
    print()
    for r in rows:
        if "skip" not in r:
            print(f"{r['arch']} x {r['shape']}: {ADVICE[r['bottleneck']]}")


if __name__ == "__main__":
    main()
