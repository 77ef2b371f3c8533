"""Offline alignment parser CLI: PHYLIP -> binary byteFile.

The counterpart of the reference's separate `parse-examl` binary
(`parser/axml.c`, `parser/USAGE`): reads a relaxed-PHYLIP alignment and an
optional RAxML-style partition model file, pattern-compresses each
partition, computes empirical base frequencies, prints the CAT/GAMMA
memory forecast, and writes `<name>.binary`.

Usage:  python -m examl_tpu_torch.cli.parse -s ALN -m DNA|PROT|BIN -n NAME
                                            [-q partitionFile] [-c]

The port of `examl_tpu/cli/parse.py`; it writes the same byteFile.
"""

from __future__ import annotations

import argparse
import sys

MODEL_TO_DATATYPE = {"DNA": "DNA", "PROT": "AA", "BIN": "BIN",
                     "BINARY": "BIN"}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="examl_tpu_torch.cli.parse",
        description="convert a PHYLIP alignment into the binary byteFile "
                    "format read by the inference program")
    ap.add_argument("-s", dest="alignment", required=True,
                    help="relaxed PHYLIP alignment file")
    ap.add_argument("-n", dest="name", required=True,
                    help="output name (writes <name>.binary)")
    ap.add_argument("-m", dest="model", default="DNA",
                    choices=sorted(MODEL_TO_DATATYPE),
                    help="data type when no -q file is given")
    ap.add_argument("-q", dest="partition_file", default=None,
                    help="RAxML-style partition model file")
    ap.add_argument("-c", dest="no_compression", action="store_true",
                    help="disable pattern compression")
    return ap


def memory_forecast(data) -> str:
    """CAT/GAMMA CLV memory forecast (reference `parser/axml.c:2846-2882`)."""
    ntaxa = data.ntaxa
    unique = sum(p.width for p in data.partitions)
    clv_cat = sum(p.states * p.width for p in data.partitions) * ntaxa * 8
    clv_gamma = clv_cat * 4
    tips = ntaxa * unique
    lines = [f"Your alignment has {unique} unique patterns"]
    for label, req in (("CAT (PSR)", clv_cat + tips),
                       ("GAMMA", clv_gamma + tips)):
        lines.append(
            f"Under {label} the memory required for storing CLVs and tip "
            f"vectors will be {req} bytes ({req / 2**20:.1f} MB, "
            f"{req / 2**30:.2f} GB)")
    lines.append("Note these are only the likelihood-buffer requirements; "
                 "leave headroom for the rest of the run.")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from examl_tpu_torch.io.alignment import load_alignment
    from examl_tpu_torch.io.bytefile import write_bytefile

    data = load_alignment(args.alignment, args.partition_file,
                          datatype_name=MODEL_TO_DATATYPE[args.model],
                          compress=not args.no_compression)
    print(f"Pattern compression: "
          f"{'OFF' if args.no_compression else 'ON'}")
    print(memory_forecast(data))
    out = f"{args.name}.binary"
    write_bytefile(out, data)
    print(f"Binary and compressed alignment file written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
