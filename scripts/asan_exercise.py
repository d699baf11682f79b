"""AddressSanitizer exercise for the native library (run via run_asan.sh).

Drives every native entry point through realistic inputs using only
numpy + ctypes (pytest/scipy/jax wheels abort under ASAN's interceptors,
so this is a standalone driver rather than the test suite).
"""

import ctypes
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, ".")

import numpy as np

from genome_downsampler_tpu.config import BamApiConfig
from genome_downsampler_tpu.io.bam import read_bam, read_bam_region, write_bam
from genome_downsampler_tpu.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu.solvers.native_mcmf import (
    mcmf_select_bucketed,
    mcmf_select_convex,
)
from genome_downsampler_tpu.testing.bam_writer import write_test_bam
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform


def main():
    rng = np.random.default_rng(7)
    batch = rand_reads_uniform(rng, 5_000, 30_000, 150)
    tmp = Path(tempfile.mkdtemp())
    path = tmp / "in.bam"
    write_test_bam(path, batch, coordinate_sorted=True, make_index=True)

    cfg = BamApiConfig(min_mapq=0, min_seq_length=0, hts_thread_count=4)
    full, fo, _ = read_bam(path, cfg)
    assert full.n_reads == batch.n_reads
    region, _, _ = read_bam_region(path, cfg, 5_000, 20_000)
    assert region.n_reads > 0
    write_bam(path, tmp / "o1.bam", full.bam_id[: full.n_reads // 2])
    write_bam(path, tmp / "o2.bam", region.bam_id, ids_are_voffsets=True)

    s = np.asarray(full.start, np.int64)
    e = np.asarray(full.end, np.int64)
    q = np.asarray(full.quality, np.int64)
    sel = native_greedy_select(s, e, 30_000, 8)
    assert len(sel) > 0
    c = q.max() - q + 1
    sel2 = mcmf_select_convex(s, e, c, 30_000, 8)
    sel3 = mcmf_select_bucketed(s, e, c, 30_000, 8)
    cost2 = int(c[sel2].sum())
    cost3 = int(c[sel3].sum())
    assert cost2 == cost3, (cost2, cost3)

    # packing (direct ctypes: ops.pallas_blocked pulls in jax)
    from genome_downsampler_tpu.io.build import build_bamio

    lib = ctypes.CDLL(str(build_bamio()))
    lib.gd_pack_blocked.restype = ctypes.c_int64
    p_packed = ctypes.POINTER(ctypes.c_int32)()
    p_counts = ctypes.POINTER(ctypes.c_int32)()
    win = ctypes.c_int64()
    cap = ctypes.c_int64()
    p_slots = ctypes.POINTER(ctypes.c_int64)()
    rc = lib.gd_pack_blocked(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(s)), ctypes.c_int64(30_000), ctypes.c_int64(8),
        ctypes.c_int64(256), ctypes.c_int64(256), ctypes.c_int64(256),
        ctypes.c_int64(0), ctypes.c_int64(4),
        ctypes.byref(p_packed), ctypes.byref(p_counts),
        ctypes.byref(win), ctypes.byref(cap),
        ctypes.byref(p_slots),
    )
    assert rc == 0
    # outputs are arena-owned (reused across calls): NOT freed here.
    # exercise the direct flat packer on the same reads (arena overwrite
    # is the point: it must not corrupt the later consumers we re-call)
    lib.gd_pack_flat_direct.restype = ctypes.c_int64
    p_flat = ctypes.POINTER(ctypes.c_uint16)()
    p_counts2 = ctypes.POINTER(ctypes.c_int32)()
    p_slots2 = ctypes.POINTER(ctypes.c_int64)()
    win2 = ctypes.c_int64()
    cap2 = ctypes.c_int64()
    rc = lib.gd_pack_flat_direct(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(s)), ctypes.c_int64(30_000), ctypes.c_int64(8),
        ctypes.c_int64(256), ctypes.c_int64(256), ctypes.c_int64(256),
        ctypes.c_int64(0), ctypes.c_int64(4),
        ctypes.byref(p_flat), ctypes.byref(p_counts2),
        ctypes.byref(win2), ctypes.byref(cap2), ctypes.byref(p_slots2),
    )
    assert rc == 0 and win2.value == win.value
    # re-pack padded (the flat call overwrote shared arenas)
    rc = lib.gd_pack_blocked(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(s)), ctypes.c_int64(30_000), ctypes.c_int64(8),
        ctypes.c_int64(256), ctypes.c_int64(256), ctypes.c_int64(256),
        ctypes.c_int64(0), ctypes.c_int64(4),
        ctypes.byref(p_packed), ctypes.byref(p_counts),
        ctypes.byref(win), ctypes.byref(cap),
        ctypes.byref(p_slots),
    )
    assert rc == 0
    # exercise the mask bit test on the packed result
    nslots = (win.value // 256) * 8 * cap.value
    bits = np.random.default_rng(0).integers(
        0, 256, (nslots + 7) // 8, dtype=np.uint8
    )
    slots_arr = np.ctypeslib.as_array(p_slots, shape=(len(s),))
    out01 = np.empty(len(s), np.uint8)
    lib.gd_mask_select.restype = ctypes.c_int64
    lib.gd_mask_select(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        slots_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(s)),
        out01.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )

    # fuzz sweep under ASan: corrupt/truncated inputs must be rejected
    # cleanly (see tests/test_io_fuzz.py for the pytest-side corpus)
    blob = path.read_bytes()
    frng = np.random.default_rng(20260820)
    fz = tmp / "fuzz.bam"
    n_rej = 0
    for cut in range(0, len(blob), max(1, len(blob) // 32)):
        fz.write_bytes(blob[:cut])
        try:
            read_bam(fz, cfg)
        except IOError:
            n_rej += 1
    offsets = list(range(0, 40)) + sorted(
        frng.integers(0, len(blob), 120).tolist()
    )
    for off in offsets:
        mut = bytearray(blob)
        mut[off] ^= 0xFF
        fz.write_bytes(bytes(mut))
        try:
            read_bam(fz, cfg)
        except IOError:
            n_rej += 1
        try:
            write_bam(fz, tmp / "fo.bam", full.bam_id[:4])
        except IOError:
            pass
    assert n_rej > 0

    print("ASAN exercise: all native paths OK", flush=True)


if __name__ == "__main__":
    main()
