"""Time design variants of the embedding-bag and walk-step kernels in
turns on one card, each held bit-equal to its plain version first.

Run from the root of a checkout, on a machine with a CUDA card::

    PYTHONPATH=src python3 -m repro_torch.kernels.tuning.gather_variants [PREFIX ...]

With prefixes (``eb_``, ``ws_``, ``wa_``) only the variants whose names
start with one of them are built and timed.

Every variant of ``VARIANTS`` is one build of ``gather_variants.cu`` (its
-D flags; one ``nvcc`` each, all started together).  The embedding bag runs
at the SGNS step's shapes (H = 1, D = 128, R = 2^20; B = 4,096 and 20,480
bags of uniform random ids) and is timed three ways: cold after 256 MiB of
writes (L2 full of dirty lines, as after AdamW), cold after 256 MiB of
reads (L2 full of clean lines), and warm (CUDA-graph replays); then the
step's three gathers back to back (B = 4,096, 4,096, 20,480), warm and
cold.  The uniform and alias walk steps run at W = 4,096 lanes over the
main path's graph (WG at scale 20), warm and cold; the alias step also
warm right after a copy that writes its last input, as on the per-hop
path.  The SASS of the shipped walk-step kernels (``walk_step.cu``) and
of each walk-step variant is printed: its loads, compares, selects,
branches and stores in issue order.  The variants run forward, then
backward, so drift between turns shows; a 4-byte ``zero_()`` gives the
launch floor, timed the same ways.  The timers are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
ROOT = _HERE.parents[3]

#: Variant name -> its -D flags (gather_variants.cu names each).
EB = "eb_"
VARIANTS = {
    "eb_parent": ("EB_SPLIT=0", "EB_LOAD=0", "PDL=0"),
    "eb_shipped": ("EB_SPLIT=0", "EB_LOAD=1", "PDL=1"),
    "eb_parent_ldcs": ("EB_SPLIT=0", "EB_LOAD=2", "PDL=0"),
    "eb_gs": ("EB_SPLIT=1", "EB_LOAD=0", "PDL=0"),
    "eb_gs_pdl": ("EB_SPLIT=1", "EB_LOAD=1", "PDL=1"),
    "eb_u4": ("EB_SPLIT=2", "EB_UNROLL=4", "EB_LOAD=0", "PDL=0"),
    "eb_u4_min4": ("EB_SPLIT=2", "EB_UNROLL=4", "EB_MINB=4", "EB_LOAD=0",
                   "PDL=0"),
    "eb_u4_pdl": ("EB_SPLIT=2", "EB_UNROLL=4", "EB_LOAD=1", "PDL=1"),
    "eb_u8": ("EB_SPLIT=2", "EB_UNROLL=8", "EB_LOAD=0", "PDL=0"),
    "eb_u8_min3": ("EB_SPLIT=2", "EB_UNROLL=8", "EB_MINB=3", "EB_LOAD=0",
                   "PDL=0"),
    "eb_u8_ldcs": ("EB_SPLIT=2", "EB_UNROLL=8", "EB_LOAD=2", "PDL=0"),
    "eb_u8_noalloc": ("EB_SPLIT=2", "EB_UNROLL=8", "EB_LOAD=3", "PDL=0"),
    "eb_u8_pdl": ("EB_SPLIT=2", "EB_UNROLL=8", "EB_LOAD=1", "PDL=1"),
    "ws_parent256": ("WS_THREADS=256", "WS_U_EARLY=0", "PDL=0"),
    "ws_shipped32": ("WS_THREADS=32", "WS_U_EARLY=1", "PDL=1"),
    "ws_64": ("WS_THREADS=64", "WS_U_EARLY=1", "PDL=1"),
    "ws_128": ("WS_THREADS=128", "WS_U_EARLY=1", "PDL=1"),
    "ws_256": ("WS_THREADS=256", "WS_U_EARLY=1", "PDL=1"),
    "wa_parent256": ("WA_THREADS=256", "WA_EARLY=0", "PDL=0"),
    "wa_shipped32": ("WA_THREADS=32", "WA_EARLY=2", "WA_SELECT=3", "PDL=1"),
    "wa_32_plain": ("WA_THREADS=32", "WA_EARLY=1", "WA_SELECT=0", "PDL=1"),
    "wa_vol_sel0": ("WA_THREADS=32", "WA_EARLY=2", "WA_SELECT=0", "PDL=1"),
    "wa_vol_sel1": ("WA_THREADS=32", "WA_EARLY=2", "WA_SELECT=1", "PDL=1"),
    "wa_vol_sel2": ("WA_THREADS=32", "WA_EARLY=2", "WA_SELECT=2", "PDL=1"),
    "wa_32_nopdl": ("WA_THREADS=32", "WA_EARLY=2", "WA_SELECT=3", "PDL=0"),
    "wa_256": ("WA_THREADS=256", "WA_EARLY=2", "WA_SELECT=3", "PDL=1"),
}
KERNEL_OF = {"eb_": "eb_kernel", "ws_": "ws_kernel", "wa_": "wa_kernel"}
BAGS = (4_096, 20_480)
ROWS, DIM = 1 << 20, 128
WIDTH = 4_096


def build_all(out_dir: pathlib.Path, names) -> dict:
    """The named variants' libraries, built in parallel; prints ptxas'
    register lines."""
    from repro_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        flags = VARIANTS[name]
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.INCLUDE_DIR),
               *(f"-D{f}" for f in flags), "-o", str(out_dir / f"{name}.so"),
               str(_HERE / "gather_variants.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        kernel = KERNEL_OF[name[:3]]
        mine = [r for line, r in zip(
            [x for x in log.splitlines() if "Compiling entry" in x], regs)
            if kernel in line]
        print(f"{name}: {' '.join(VARIANTS[name])}; ptxas {mine}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def eb_caller(lib, idx, table, out, weights=None, grid=None):
    import torch
    from repro_torch.kernels.embedding_bag.ops import vectorized
    fn = lib.eb_variant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P] * 4 + [I] * 5 + [P, P], I
    grid = (ctypes.c_int * 2)() if grid is None else grid
    vec = int(vectorized(table, out))

    def call():
        rc = fn(idx.data_ptr(), None if weights is None else
                weights.data_ptr(), table.data_ptr(), out.data_ptr(),
                idx.shape[0], idx.shape[1], table.shape[0], table.shape[1],
                vec, torch.cuda.current_stream().cuda_stream, grid)
        if rc != 0:
            raise RuntimeError(f"eb_variant launch failed: cudaError {rc}")
    return call, grid


def ws_caller(lib, v, u, g, v_next, deg):
    import torch
    fn = lib.ws_variant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P] * 6 + [I] * 3 + [P], I

    def call():
        rc = fn(v.data_ptr(), u.data_ptr(), g.row_ptr.data_ptr(),
                g.col.data_ptr(), v_next.data_ptr(), deg.data_ptr(),
                v.shape[0], g.num_vertices, g.col.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ws_variant launch failed: cudaError {rc}")
    return call


def wa_caller(lib, v, uc, ua, g, v_next, deg):
    import torch
    fn = lib.wa_variant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P] * 9 + [I] * 3 + [P], I

    def call():
        rc = fn(v.data_ptr(), uc.data_ptr(), ua.data_ptr(),
                g.row_ptr.data_ptr(), g.col.data_ptr(),
                g.alias_prob.data_ptr(), g.alias_idx.data_ptr(),
                v_next.data_ptr(), deg.data_ptr(), v.shape[0], g.num_vertices,
                g.col.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"wa_variant launch failed: cudaError {rc}")
    return call


def print_sass(path, kernel: str, label: str) -> None:
    """The loads, compares, selects and stores of ``kernel`` in the SASS of
    the library at ``path``, in issue order (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    inside, lines = False, []
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and any(op in line for op in
                            ("LDG", "FSETP", "SEL", "STG", "BRA", "EXIT")):
            lines.append("  " + " ".join(line.replace("/*", " ").replace(
                "*/", " ").split()[:6]))
    print(f"SASS {label} ({kernel}): {len(lines)} lines")
    print("\n".join(lines))


def check_eb(libs, table, rng) -> None:
    """Each embedding-bag variant bit-equal to the plain version: the SGNS
    shapes, ragged B, H = 7 with pads and weights, D = 100 and D = 102."""
    import torch
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    dev = table.device
    t100 = torch.randn((4_096, 100), device=dev)
    t102 = torch.randn((4_096, 102), device=dev)
    cases = []
    for B, H, tbl, pads in ((4_096, 1, table, False), (20_481, 1, table, False),
                            (33, 1, table, False), (1_000, 7, table, True),
                            (1_000, 7, t100, True), (1_000, 3, t102, True)):
        lo = -1 if pads else 0
        idx = torch.from_numpy(rng.integers(lo, tbl.shape[0], (B, H))
                               .astype(np.int32)).to(dev)
        w = (torch.from_numpy(rng.random((B, H), dtype=np.float32)).to(dev)
             if pads else None)
        cases.append((idx, tbl, w, embedding_bag_ref(idx, tbl, w)))
    for name, lib in libs.items():
        if not name.startswith(EB):
            continue
        for idx, tbl, w, want in cases:
            out = torch.empty_like(want)
            call, _ = eb_caller(lib, idx, tbl, out, w)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} differs from the plain version "
                                     f"at {tuple(idx.shape)} x "
                                     f"{tbl.shape[1]}")
    print("every eb variant bit-equal to the plain version (tolerance 0)")


def time_clean(fn, flush, reps=30) -> float:
    """As chip_smoke.time_cold, but the flush reads: L2 holds clean lines."""
    import torch
    samples = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples[2:]))


def main(prefixes=()) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.walk_step.ref import walk_step_uniform_ref
    if not torch.cuda.is_available():
        print("gather_variants needs a CUDA card", file=sys.stderr)
        return 1
    names = [n for n in VARIANTS
             if not prefixes or n.startswith(tuple(prefixes))]
    if not names:
        print(f"no variant starts with {prefixes}", file=sys.stderr)
        return 1
    libs = build_all(ROOT / "build" / "gather_variants", names)
    print(cs.card_line())
    rng = np.random.default_rng(0)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    print(f"launch floor: warm {cs.time_launches(one.zero_):.7f} ms, cold "
          f"dirty {cs.time_cold(one.zero_):.7f} ms, cold clean "
          f"{time_clean(one.zero_, flush):.7f} ms")
    ebs = [n for n in names if n.startswith(EB)]
    if ebs:
        time_eb(cs, libs, ebs, rng, flush)
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=cs.WG_SCALE)
    v, u, ua = cs.kernel_inputs(g, WIDTH, seed=WIDTH)
    want = walk_step_uniform_ref(v, u, g.row_ptr, g.col)
    wss = [n for n in names if n.startswith("ws_")]
    for turn, name in enumerate(wss + wss[::-1]):
        v_next, deg = torch.empty_like(v), torch.empty_like(v)
        call = ws_caller(libs[name], v, u, g, v_next, deg)
        call()
        torch.cuda.synchronize()
        if not (torch.equal(v_next, want[0]) and torch.equal(deg, want[1])):
            raise AssertionError(f"{name} differs from the plain version")
        print(f"ws W={WIDTH} turn {turn} {name}: bit-equal; warm "
              f"{cs.time_launches(call):.7f} ms, cold dirty "
              f"{cs.time_cold(call):.7f} ms")
    build.load("walk_step")
    for kernel in ("walk_step_uniform_kernel", "walk_step_alias_kernel"):
        print_sass(build.library_path("walk_step"), kernel,
                   "walk_step.cu (shipped)")
    for name in names:
        if not name.startswith(EB):
            print_sass(ROOT / "build" / "gather_variants" / f"{name}.so",
                       KERNEL_OF[name[:3]], name)
    was = [n for n in names if n.startswith("wa_")]
    if was:
        time_wa(cs, libs, was, g)
    print(f"launch floor again: warm {cs.time_launches(one.zero_):.7f} ms, "
          f"cold dirty {cs.time_cold(one.zero_):.7f} ms")
    return 0


def time_wa(cs, libs, names, g) -> None:
    """Each alias variant bit-equal to the plain version at W = 1, 33,
    4,096 and 12,288, then timed in turns at W = 4,096: warm, cold, and
    warm right after a copy that writes u_acc (the per-hop path's order:
    the copy of the second uniform column, then the step)."""
    import torch
    from repro_torch.kernels.walk_step.ref import walk_step_alias_ref
    for width in (1, 33, WIDTH, 12_288):
        v, uc, ua = cs.kernel_inputs(g, width, seed=width)
        want = walk_step_alias_ref(v, uc, ua, g.row_ptr, g.col, g.alias_prob,
                                   g.alias_idx)
        for name in names:
            v_next, deg = torch.empty_like(v), torch.empty_like(v)
            wa_caller(libs[name], v, uc, ua, g, v_next, deg)()
            torch.cuda.synchronize()
            if not (torch.equal(v_next, want[0])
                    and torch.equal(deg, want[1])):
                raise AssertionError(f"{name} differs from the plain version "
                                     f"at W={width}")
    print("every wa variant bit-equal to the plain version at W = 1, 33, "
          f"{WIDTH}, 12288 (tolerance 0)")
    v, uc, ua = cs.kernel_inputs(g, WIDTH, seed=WIDTH)
    u2 = torch.stack([uc, ua], 1)
    for turn, name in enumerate(names + names[::-1]):
        v_next, deg = torch.empty_like(v), torch.empty_like(v)
        call = wa_caller(libs[name], v, uc, ua, g, v_next, deg)

        def after_copy(call=call):
            ua.copy_(u2[:, 1])
            call()
        print(f"wa W={WIDTH} turn {turn} {name}: warm "
              f"{cs.time_launches(call):.7f} ms, cold dirty "
              f"{cs.time_cold(call):.7f} ms, copy + step warm "
              f"{cs.time_launches(after_copy):.7f} ms")


def time_eb(cs, libs, ebs, rng, flush) -> None:
    """The embedding-bag variants: bit-equal first, then in turns."""
    import torch
    table = torch.randn((ROWS, DIM), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    check_eb({n: libs[n] for n in ebs}, table, rng)
    ids = {B: torch.from_numpy(rng.integers(0, ROWS, (B, 1)).astype(np.int32))
           .cuda() for B in BAGS}
    for B in BAGS:
        for turn, name in enumerate(ebs + ebs[::-1]):
            out = torch.empty((B, DIM), device="cuda")
            call, grid = eb_caller(libs[name], ids[B], table, out)
            print(f"eb B={B} turn {turn} {name}: cold dirty "
                  f"{cs.time_cold(call):.6f} ms, cold clean "
                  f"{time_clean(call, flush):.6f} ms, warm "
                  f"{cs.time_launches(call):.6f} ms; grid {grid[0]} blocks, "
                  f"{grid[1]} bags a warp")
    for turn, name in enumerate(ebs + ebs[::-1]):
        calls = [eb_caller(libs[name], ids[B], table,
                           torch.empty((B, DIM), device="cuda"))[0]
                 for B in (4_096, 4_096, 20_480)]

        def gathers():
            for c in calls:
                c()
        print(f"eb three gathers turn {turn} {name}: warm "
              f"{cs.time_launches(gathers):.6f} ms, cold dirty "
              f"{cs.time_cold(gathers):.6f} ms")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
