"""The dry-run and roofline tables of the port's dry-run reports,
reports/dryrun_torch/<mesh>/*.json (counterpart of repro/roofline/report.py;
the reference's reports live in reports/dryrun, never read here).

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh pod_16x16]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .analysis import HBM_PER_CHIP

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")
SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}
FIT_COLUMN = f"fit{HBM_PER_CHIP / 2 ** 30:.1f}GiB"


def load(mesh: str, include_tagged: bool = False,
         report_dir: str = REPORT_DIR) -> list[dict]:
    rows = []
    for path in glob.glob(os.path.join(report_dir, mesh, "*.json")):
        with open(path) as f:
            r = json.load(f)
        stem = os.path.splitext(os.path.basename(path))[0]
        if not include_tagged and stem != f"{r['arch']}__{r['shape']}":
            continue  # hillclimb/diagnostic variants
        rows.append(r)
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    return rows


def fmt_dryrun_table(rows: list[dict]) -> str:
    out = [f"| arch | shape | status | HBM GB/chip | {FIT_COLUMN} | "
           f"trace s |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR: "
                       f"{r.get('error', '?')[:60]} | — | — | "
                       f"{r.get('compile_s', 0)} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{r.get('hbm_gb_per_chip', float('nan')):.2f} | "
            f"{'Y' if r.get('hbm_fit') else 'N'} | {r['compile_s']:.0f} |")
    return "\n".join(out)


def fmt_roofline_table(rows: list[dict]) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL/traced flops | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"{r['bottleneck']} | {r.get('model_flops_ratio', 0):.2f} | "
            f"{r.get('roofline_fraction', 0):.3f} |")
    return "\n".join(out)


def pick_hillclimb(rows: list[dict]) -> list[tuple[str, str, str]]:
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        return []
    worst = min(ok, key=lambda r: r.get("roofline_fraction", 1.0))
    coll = max(ok, key=lambda r: (r["collective_s"] /
                                  max(1e-12, max(r["compute_s"],
                                                 r["memory_s"]))))
    return [(worst["arch"], worst["shape"], "worst roofline fraction"),
            (coll["arch"], coll["shape"], "most collective-bound")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod_16x16")
    args = ap.parse_args(argv)
    rows = load(args.mesh)
    print(f"## Dry-run ({args.mesh}, {len(rows)} cells)\n")
    print(fmt_dryrun_table(rows))
    print(f"\n## Roofline ({args.mesh})\n")
    print(fmt_roofline_table(rows))
    print("\nhillclimb candidates:", pick_hillclimb(rows))


if __name__ == "__main__":
    main()
