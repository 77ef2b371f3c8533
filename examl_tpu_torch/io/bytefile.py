"""Binary "byteFile" alignment format, compatible with the reference parser.

Layout (reference writer `parser/axml.c:2752-2887`, reader
`examl/byteFile.c:31-433`):

  int32  sizeof(size_t) on the writing system (must be 8)
  int32  version            (3022)
  int32  magic              (6517718)
  int32  numTax
  uint64 numPattern          (global, over all partitions)
  int32  numPartitions
  f64    gappyness
  int32[numPattern]          pattern weights
  per taxon:      int32 len; char[len] name (NUL-terminated)
  per partition:  int32 states; int32 maxTipStates; uint64 lower;
                  uint64 upper; uint64 width; int32 dataType;
                  int32 protModels; int32 protFreqs; int32 nonGTR;
                  int32 optimizeBaseFrequencies;
                  int32 len; char[len] name; f64[states] frequencies
  alignment:      per partition, per taxon: uint8[upper-lower] codes
                  (partition-major, taxon-major within partition)

State codes are the reference's meaning-table values, which
examl_tpu_torch.datatypes reproduces (DNA: IUPAC bitmask 1-15; AA: 0-19 + B=20,
Z=21, X/-=22; BIN: 1, 2, 3).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from examl_tpu_torch import datatypes
from examl_tpu_torch.io.alignment import (AlignmentData, PartitionData,
                                    empirical_frequencies)

BYTEFILE_VERSION = 3022
BYTEFILE_MAGIC = 6517718

# Reference enum values (examl/axml.h:240-264, 307-314).
DATATYPE_INT = {"BIN": 0, "DNA": 1, "AA": 2}
DATATYPE_NAME = {v: k for k, v in DATATYPE_INT.items()}
PROT_MODELS = ["DAYHOFF", "DCMUT", "JTT", "MTREV", "WAG", "RTREV", "CPREV",
               "VT", "BLOSUM62", "MTMAM", "LG", "MTART", "MTZOA", "PMB",
               "HIVB", "HIVW", "JTTDCMUT", "FLU", "STMTREV", "AUTO",
               "LG4M", "LG4X", "GTR"]
PROT_INDEX = {m: i for i, m in enumerate(PROT_MODELS)}
JTT = PROT_INDEX["JTT"]


def _w(f, fmt: str, *vals) -> None:
    f.write(struct.pack("<" + fmt, *vals))


def _r(f, fmt: str):
    size = struct.calcsize("<" + fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError("truncated byteFile")
    return struct.unpack("<" + fmt, data)


def _write_string(f, s: str) -> None:
    b = s.encode("utf-8") + b"\0"
    _w(f, "i", len(b))
    f.write(b)


def _read_string(f) -> str:
    (n,) = _r(f, "i")
    return f.read(n).rstrip(b"\0").decode("utf-8")


def gappyness(parts: Sequence[PartitionData]) -> float:
    """Share of fully-undetermined characters, weighted by pattern counts."""
    undet = total = 0
    for p in parts:
        w = p.weights[None, :]
        undet += int(((p.patterns == p.datatype.undetermined_code) * w).sum())
        total += int(p.patterns.shape[0] * p.weights.sum())
    return undet / total if total else 0.0


def write_bytefile(path: str, data: AlignmentData) -> None:
    """Write an AlignmentData (already pattern-compressed) as a byteFile."""
    parts = data.partitions
    num_pattern = sum(p.width for p in parts)
    with open(path, "wb") as f:
        _w(f, "iii", 8, BYTEFILE_VERSION, BYTEFILE_MAGIC)
        _w(f, "i", data.ntaxa)
        _w(f, "Q", num_pattern)
        _w(f, "i", len(parts))
        _w(f, "d", gappyness(parts))
        weights = np.concatenate([p.weights for p in parts]).astype("<i4")
        f.write(weights.tobytes())
        for name in data.taxon_names:
            _write_string(f, name)
        lower = 0
        for p in parts:
            upper = lower + p.width
            if p.datatype.name == "AA":
                prot = PROT_INDEX.get("AUTO" if p.auto else p.model_name, JTT)
            else:
                prot = JTT                   # ignored for non-AA (ref default)
            _w(f, "ii", p.states, p.datatype.num_codes)
            _w(f, "QQQ", lower, upper, upper - lower)
            _w(f, "iiiii", DATATYPE_INT[p.datatype.name], prot,
               int(p.use_empirical_freqs), 0, int(p.optimize_freqs))
            _write_string(f, p.name)
            f.write(np.asarray(p.empirical_freqs, dtype="<f8").tobytes())
            lower = upper
        for p in parts:
            f.write(np.ascontiguousarray(p.patterns, dtype=np.uint8).tobytes())


@dataclass
class BytePartMeta:
    """Per-partition byteFile metadata plus the byte offset of its
    pattern data section (partition-major, taxon-major within)."""
    states: int
    lower: int                  # global pattern range [lower, upper)
    upper: int
    dtype_i: int
    prot: int
    prot_freqs: bool
    opt_freqs: bool
    name: str
    freqs: np.ndarray
    data_offset: int

    @property
    def width(self) -> int:
        return self.upper - self.lower


@dataclass
class ByteFileMeta:
    """Everything in a byteFile EXCEPT weights and pattern data — the
    seek map for selective per-process reads (reference `seekPos`,
    `byteFile.c:31-83`)."""
    path: str
    ntaxa: int
    num_pattern: int
    taxon_names: List[str]
    parts: List[BytePartMeta]
    weights_offset: int


def read_bytefile_meta(path: str) -> ByteFileMeta:
    """Parse header + taxon names + partition metadata; SEEK past the
    weights and pattern sections so host memory and IO stay O(metadata)
    regardless of alignment size."""
    with open(path, "rb") as f:
        szt, version, magic = _r(f, "iii")
        if magic != BYTEFILE_MAGIC:
            raise ValueError(f"{path}: not a byteFile (magic {magic})")
        if szt != 8:
            raise ValueError(f"{path}: written on a {8 * szt}-bit system")
        if version != BYTEFILE_VERSION:
            raise ValueError(f"{path}: byteFile version {version}, "
                             f"expected {BYTEFILE_VERSION}")
        (ntaxa,) = _r(f, "i")
        (num_pattern,) = _r(f, "Q")
        (num_parts,) = _r(f, "i")
        _r(f, "d")                                    # gappyness (stats only)
        weights_offset = f.tell()
        f.seek(4 * num_pattern, 1)
        names = [_read_string(f) for _ in range(ntaxa)]
        parts: List[BytePartMeta] = []
        for _ in range(num_parts):
            states, _max_tip = _r(f, "ii")
            lower, upper, _width = _r(f, "QQQ")
            dtype_i, prot, prot_freqs, _non_gtr, opt_freqs = _r(f, "iiiii")
            pname = _read_string(f)
            freqs = np.frombuffer(f.read(8 * states), dtype="<f8")
            parts.append(BytePartMeta(
                states=states, lower=int(lower), upper=int(upper),
                dtype_i=dtype_i, prot=prot, prot_freqs=bool(prot_freqs),
                opt_freqs=bool(opt_freqs), name=pname, freqs=freqs,
                data_offset=0))
        off = f.tell()
        for pm in parts:
            pm.data_offset = off
            off += ntaxa * pm.width
    return ByteFileMeta(path=path, ntaxa=ntaxa, num_pattern=int(num_pattern),
                        taxon_names=names, parts=parts,
                        weights_offset=weights_offset)


def _read_columns(f, meta: ByteFileMeta, pm: BytePartMeta, lo: int,
                  hi: int) -> np.ndarray:
    """[ntaxa, hi-lo] codes of partition columns [lo, hi) via one seek
    per taxon row (reference `readMyData`, `byteFile.c:278-382`)."""
    w = pm.width
    n = hi - lo
    out = np.empty((meta.ntaxa, n), dtype=np.uint8)
    for t in range(meta.ntaxa):
        f.seek(pm.data_offset + t * w + lo)
        row = f.read(n)
        if len(row) != n:
            raise ValueError("truncated byteFile")
        out[t] = np.frombuffer(row, dtype=np.uint8)
    return out


def _part_from_meta(pm: BytePartMeta, patterns: np.ndarray,
                    weights: np.ndarray, col_offset: int = 0,
                    global_weight_sum: int | None = None) -> PartitionData:
    dt = datatypes.get(DATATYPE_NAME[pm.dtype_i])
    if dt.name == "AA":
        model_name = PROT_MODELS[pm.prot]
    elif dt.name == "DNA":
        model_name = "DNA"
    else:
        model_name = "BIN"
    emp = np.asarray(pm.freqs, dtype=np.float64)
    if not np.isfinite(emp).all() or emp.sum() <= 0:
        if patterns.shape[1] != pm.width:
            # A sliced read MUST NOT salvage from its own columns: each
            # process would derive different frequencies from the same
            # file and the replicated model arrays would silently
            # diverge across the job.
            raise ValueError(
                f"partition {pm.name!r}: byteFile stores no usable "
                f"frequencies and this is a per-process sliced read; "
                f"re-run the parser or use a whole-file read")
        emp = empirical_frequencies(patterns, weights, dt)
    return PartitionData(
        name=pm.name, datatype=dt, model_name=model_name,
        patterns=np.ascontiguousarray(patterns),
        weights=weights.astype(np.int64),
        empirical_freqs=emp,
        use_empirical_freqs=pm.prot_freqs or dt.name != "AA",
        optimize_freqs=pm.opt_freqs,
        lg4=model_name in ("LG4M", "LG4X"), auto=model_name == "AUTO",
        global_width=pm.width if patterns.shape[1] != pm.width else None,
        global_col_offset=col_offset, global_weight_sum=global_weight_sum)


def read_bytefile(path: str) -> AlignmentData:
    """Read a byteFile (ours or the reference parser's) into AlignmentData."""
    meta = read_bytefile_meta(path)
    with open(path, "rb") as f:
        f.seek(meta.weights_offset)
        wbytes = f.read(4 * meta.num_pattern)
        if len(wbytes) != 4 * meta.num_pattern:
            raise ValueError("truncated byteFile")
        weights = np.frombuffer(wbytes, dtype="<i4")
        parts: List[PartitionData] = []
        for pm in meta.parts:
            f.seek(pm.data_offset)
            raw = np.frombuffer(f.read(meta.ntaxa * pm.width),
                                dtype=np.uint8)
            if raw.size != meta.ntaxa * pm.width:
                raise ValueError("truncated byteFile")
            parts.append(_part_from_meta(
                pm, raw.reshape(meta.ntaxa, pm.width),
                weights[pm.lower:pm.upper].astype(np.int64)))
    return AlignmentData(meta.taxon_names, parts)


def read_bytefile_slice(path: str,
                        columns: dict[int, tuple[int, int]]) -> AlignmentData:
    """Read only the given per-partition column windows.

    `columns` maps partition index -> (col_lo, col_hi) relative to the
    partition; partitions absent from the map come back with width 0
    (metadata — models, frequencies, names — is always global).  Host
    memory and IO are proportional to the WINDOW, not the alignment
    (the weights SECTION is still read whole — 4 bytes/pattern, needed
    for process-count-invariant checkpoint fingerprints): this is the
    reference's `readMyData` (`byteFile.c:278-382`), where each MPI rank
    seeks and reads only its assigned site blocks."""
    meta = read_bytefile_meta(path)
    with open(path, "rb") as f:
        f.seek(meta.weights_offset)
        wbytes = f.read(4 * meta.num_pattern)
        if len(wbytes) != 4 * meta.num_pattern:
            raise ValueError("truncated byteFile")
        all_weights = np.frombuffer(wbytes, dtype="<i4")
        parts: List[PartitionData] = []
        for gid, pm in enumerate(meta.parts):
            lo, hi = columns.get(gid, (0, 0))
            if not (0 <= lo <= hi <= pm.width):
                raise ValueError(
                    f"partition {gid}: window [{lo},{hi}) outside "
                    f"[0,{pm.width})")
            patterns = _read_columns(f, meta, pm, lo, hi)
            weights = all_weights[pm.lower + lo:pm.lower + hi].astype(
                np.int64)
            gsum = int(all_weights[pm.lower:pm.upper].sum())
            parts.append(_part_from_meta(pm, patterns, weights,
                                         col_offset=lo,
                                         global_weight_sum=gsum))
    return AlignmentData(meta.taxon_names, parts)


def read_bytefile_for_process(path: str, procid: int, nprocs: int,
                              block_multiple: int | None = None
                              ) -> AlignmentData:
    """Read only the site columns process `procid` of `nprocs` owns.

    The packed-bucket layout (parallel/packing.py) is a pure function of
    the header metadata, so the process's block range — and its pre-image
    in per-partition pattern columns — is computed WITHOUT touching
    pattern data; then only those columns are seek-read.  Peak host
    memory scales ~1/nprocs of the alignment.  `block_multiple` must
    match the packing used at instance build (defaults to nprocs)."""
    from examl_tpu_torch.parallel.packing import pack_layout

    if not (0 <= procid < nprocs):
        raise ValueError(f"procid {procid} outside [0, {nprocs})")
    meta = read_bytefile_meta(path)
    layouts = pack_layout(
        [(gid, pm.states, pm.width) for gid, pm in enumerate(meta.parts)],
        block_multiple=block_multiple or nprocs)
    columns: dict[int, tuple[int, int]] = {}
    for lay in layouts.values():
        for gid, lo, hi in lay.process_columns(procid, nprocs):
            columns[gid] = (lo, hi)
    return read_bytefile_slice(path, columns)
