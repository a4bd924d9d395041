"""crushtool-equivalent CLI — src/tools/crushtool.cc; the port of
``ceph_tpu.bench.crushtool``.

Supported surface (the --test path is the north-star bulk-remap metric):

  python -m ceph_tpu_torch.bench.crushtool -i map.txt --test \\
      --rule 0 --num-rep 3 --min-x 0 --max-x 999999 \\
      --show-statistics [--show-mappings] [--engine bulk|host] \\
      [--device cuda|cpu] [--choose-args NAME] [--weight DEV W]...
  python -m ceph_tpu_torch.bench.crushtool --build-two-level H D -o map.txt
  python -m ceph_tpu_torch.bench.crushtool -d map.txt  (decompile: print)

``--engine bulk`` (the default) runs the bulk evaluator on ``--device``:
the card by default (NoDeviceError without one), ``cpu`` on the CPU.

Maps are read in either interchange form — the crushtool text grammar
(the format `crushtool -d` emits from live clusters; auto-detected) or
this framework's JSON (first non-space byte '{').  -o writes text by
default, JSON when the filename ends in .json.

Output format follows crushtool --test --show-statistics: per-device
placement counts plus a mappings/s line (the benchmark figure).
"""

from __future__ import annotations

import argparse
import sys

from ..crush.builder import CrushBuilder
from ..crush.compiler import compile_map, decompile
from ..crush.tester import test_rule
from ..crush.binary import CRUSH_MAGIC, decode_map, encode_map
from ..crush.text_compiler import compile_text, decompile_text
from ..crush.types import CRUSH_ITEM_NONE

import struct


def read_map(path: str):
    """Auto-detect interchange form: binary (CRUSH_MAGIC), JSON ('{'
    first), or crushtool text grammar."""
    raw = open(path, "rb").read()
    if len(raw) >= 4 and struct.unpack("<I", raw[:4])[0] == CRUSH_MAGIC:
        return decode_map(raw)
    text = raw.decode()
    if text.lstrip().startswith("{"):
        return compile_map(text)
    return compile_text(text)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool",
                                description=__doc__.split("\n")[0])
    p.add_argument("-i", "--infn",
                   help="input map (crushtool text or JSON, auto)")
    p.add_argument("-o", "--outfn",
                   help="output map (text; JSON for .json suffix)")
    p.add_argument("-d", "--decompile", metavar="MAP",
                   help="print the crushtool text form of MAP")
    p.add_argument("--format", choices=("text", "json", "bin"),
                   help="output form for -d/-o (default: text, or by "
                        "-o suffix: .json / .bin)")
    p.add_argument("--choose-args", metavar="NAME",
                   help="apply the named choose_args set during --test")
    p.add_argument("--build-two-level", nargs=2, type=int,
                   metavar=("HOSTS", "DEVS"),
                   help="build a root->host->osd straw2 map")
    p.add_argument("--test", action="store_true",
                   help="run mapping sweep (CrushTester)")
    p.add_argument("--rule", type=int, default=0)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-utilization", action="store_true",
                   help="per-device actual vs weight-expected placements")
    p.add_argument("--engine", choices=("host", "bulk"), default="bulk")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --engine bulk runs (default: the card)")
    p.add_argument("--weight", nargs=2, action="append", default=[],
                   metavar=("DEV", "W"),
                   help="override device weight (float, 1.0 = in)")
    # crushtool edit surface (CrushWrapper insert/remove/adjust)
    p.add_argument("--add-item", nargs=3, metavar=("ID", "W", "NAME"),
                   help="add device ID with weight W (float) named "
                        "NAME into the bucket given by --loc")
    p.add_argument("--loc", nargs=2, metavar=("TYPE", "NAME"),
                   help="location bucket for --add-item")
    p.add_argument("--remove-item", metavar="NAME",
                   help="remove the named item from every bucket")
    p.add_argument("--reweight-item", nargs=2, metavar=("NAME", "W"),
                   help="set the named item's weight (float) everywhere "
                        "and repropagate ancestors")
    args = p.parse_args(argv)

    if args.decompile:
        cmap = read_map(args.decompile)
        print(decompile(cmap) if args.format == "json"
              else decompile_text(cmap), end="")
        return 0

    cmap = None
    if args.infn:
        cmap = read_map(args.infn)
    elif args.build_two_level:
        h, d = args.build_two_level
        b = CrushBuilder()
        root = b.build_two_level(h, d)
        b.add_simple_rule(0, root, "host", firstn=True, name="replicated")
        b.add_simple_rule(1, root, "host", firstn=False, name="erasure")
        cmap = b.map
    if cmap is None:
        p.error("need -i MAP or --build-two-level")

    if args.add_item or args.remove_item or args.reweight_item:
        b = CrushBuilder.from_map(cmap)

        def item_of(name):
            # fresh lookup per call: an --add-item earlier in the SAME
            # invocation must be visible to --reweight-item/--remove
            for iid, nm in cmap.item_names.items():
                if nm == name:
                    return iid
            p.error(f"no item named {name!r} in map")

        try:
            if args.add_item:
                dev, w, name = args.add_item
                dev = int(dev)
                if not args.loc:
                    p.error("--add-item requires --loc TYPE NAME")
                if any(dev in bk.items for bk in cmap.buckets.values()):
                    p.error(f"item {dev} already exists in the map "
                            "(CrushWrapper::insert_item rejects "
                            "duplicates)")
                if name in cmap.item_names.values():
                    p.error(f"name {name!r} already used in the map")
                loc_type, loc_name = args.loc
                target = item_of(loc_name)
                if target >= 0:
                    p.error(f"--loc: {loc_name!r} is a device, not a "
                            f"bucket")
                bt = cmap.buckets[target].type
                if cmap.type_names.get(bt) != loc_type:
                    p.error(f"--loc: {loc_name!r} is a "
                            f"{cmap.type_names.get(bt)!r}, not "
                            f"{loc_type!r}")
                b.insert_item(dev, int(float(w) * 0x10000),
                              target, name=name)
                print(f"add_item {dev} weight {w} to {loc_name}",
                      file=sys.stderr)
            if args.remove_item:
                n = b.remove_item(item_of(args.remove_item))
                print(f"remove_item {args.remove_item}: {n} buckets "
                      f"changed", file=sys.stderr)
            if args.reweight_item:
                name, w = args.reweight_item
                n = b.adjust_item_weight(item_of(name),
                                         int(float(w) * 0x10000))
                print(f"reweight_item {name} -> {w}: {n} buckets "
                      f"changed", file=sys.stderr)
        except (ValueError, KeyError) as e:
            raise SystemExit(f"crushtool: {e}")

    if args.outfn:
        fmt = args.format
        if fmt is None:
            fmt = ("json" if args.outfn.endswith(".json")
                   else "bin" if args.outfn.endswith(".bin") else "text")
        if fmt == "bin":
            with open(args.outfn, "wb") as f:
                f.write(encode_map(cmap))
        else:
            with open(args.outfn, "w") as f:
                f.write(decompile(cmap) if fmt == "json"
                        else decompile_text(cmap))
        print(f"wrote {args.outfn}", file=sys.stderr)

    if args.test:
        weight = cmap.device_weights()
        for dev, w in args.weight:
            weight[int(dev)] = int(float(w) * 0x10000)
        choose_args = None
        if args.choose_args is not None:
            choose_args = cmap.choose_args.get(args.choose_args)
            if choose_args is None:
                p.error(f"map has no choose_args set "
                        f"{args.choose_args!r}")
        res = test_rule(cmap, args.rule, args.num_rep, args.min_x,
                        args.max_x, weight=weight, engine=args.engine,
                        keep_mappings=args.show_mappings,
                        choose_args=choose_args, device=args.device)
        if args.show_mappings:
            for i, row in enumerate(res.mappings):
                devs = [int(d) for d in row if d != CRUSH_ITEM_NONE]
                print(f"CRUSH rule {args.rule} x {args.min_x + i} {devs}")
        if args.show_utilization:
            from ..crush.balancer import osd_crush_weights
            print(res.utilization_report(
                [int(w) for w in osd_crush_weights(cmap)],
                reweights=weight))
        if args.show_statistics or not (args.show_mappings
                                        or args.show_utilization):
            print(res.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
