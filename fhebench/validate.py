"""Check BENCHMARK.json against the rules its readers rely on.

    python fhebench/validate.py [path/to/BENCHMARK.json]

Names use only letters, digits, ``_``, ``.`` and ``-``; units 1–16 of those
plus ``/`` and ``%``; each entry has exactly its keys; every file and
metric reader named exists; and every per-layer metric's ``moves`` is an
end-to-end metric that each cell reporting the metric reports too.  Prints
the faults found and exits 1 if there are any.
"""
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from fhebench.generator import MIX_KEYS  # noqa: E402
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def faults(bench: dict) -> list[str]:
    out = []
    if set(bench) != KEYS["top"]:
        out.append(f"top-level keys {sorted(bench)}")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e.get("name") for e in bench.get(group, [])]
        if len(names) != len(set(names)):
            out.append(f"{group}: names repeat")
        for e in bench.get(group, []):
            extra = set(e) - KEYS[group] - ({"workloads"} if group in (
                "end_to_end", "per_layer") else set())
            if extra or not KEYS[group] <= set(e):
                out.append(f"{group} {e.get('name')}: keys {sorted(e)}")
            if not NAME.match(str(e.get("name", ""))):
                out.append(f"{group}: bad name {e.get('name')!r}")
            for k in ("why", "layer", "source"):
                if k in e and not TEXT.match(str(e[k])):
                    out.append(f"{group} {e['name']}: bad {k}")
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{group} {e['name']}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{group} {e['name']}: better {e['better']!r}")
            if group in ("end_to_end", "per_layer") and e.get("source") not in SOURCES:
                out.append(f"{group} {e['name']}: source {e.get('source')!r}")
            if group in ("end_to_end", "per_layer") and not (
                    HERE / "metrics" / f"{e['name']}.py").exists():
                out.append(f"{group} {e['name']}: no reader metrics/{e['name']}.py")
    metrics = len(set(m["name"] for m in bench["end_to_end"] + bench["per_layer"]))
    if metrics != len(bench["end_to_end"]) + len(bench["per_layer"]):
        out.append("a metric name repeats across end_to_end and per_layer")
    for c in bench["configs"]:
        if not (ROOT / c["file"]).exists():
            out.append(f"config {c['name']}: no file {c['file']}")
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair repeats")
    for w in bench["workloads"]:
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config")
        if not NAME.match(w["traffic"]) or not (
                HERE / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"workload {w['name']}: no traffic/{w['traffic']}.json")
        else:
            mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
            extra = set(mix) - MIX_KEYS
            if extra:
                out.append(f"workload {w['name']}: mix keys {sorted(extra)} unread")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
    if "setup_s" not in {m["name"] for m in bench["end_to_end"]}:
        out.append("no setup_s")
    for m in bench["end_to_end"]:
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")

    def reports(metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", cells)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            if cell not in cells:
                out.append(f"{m['name']}: unknown workload {cell}")
            elif m["moves"] not in e2e or not reports(e2e[m["moves"]], cell):
                out.append(f"{m['name']}: cell {cell} does not report {m['moves']}")
    for cell in cells:
        if not any(reports(m, cell) for m in bench["per_layer"]):
            out.append(f"{cell}: no per-layer metric")
        if not any(reports(m, cell) for m in bench["end_to_end"]
                   if m["name"] != "setup_s"):
            out.append(f"{cell}: no end-to-end metric besides setup_s")
    if not 1 <= bench["run_seconds"] <= 51 or int(bench["run_seconds"]) != bench["run_seconds"]:
        out.append(f"run_seconds {bench['run_seconds']}")
    for p in bench["paths"]:
        if not re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) or p.startswith("/") or ".." in p:
            out.append(f"bad path {p!r}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = Path(argv[0]) if argv else ROOT / "BENCHMARK.json"
    found = faults(json.loads(path.read_text()))
    for f in found:
        print(f"BENCHMARK.json: {f}")
    if not found:
        print("BENCHMARK.json: ok")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
