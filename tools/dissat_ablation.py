"""Where kernels 1 and 3 spend their time on the card: text variants of
``src/repro_torch/kernels/csrc/dissatisfaction.cu`` (how a block reads its
rows, rows per block, template K against runtime K) built side by side with
the repo's nvcc flags and timed in turns (CUDA events around a loop that
only calls the C entry point) at kernel 1's (N, K) = (16384, 16) and
(10^6, 8) and kernel 3's (B, N, K) = (32, 4096, 16), operands drawn from
``default_rng(0)``.  Each loop cycles through copies of the operands, four
times the L2 in all, so every call reads its inputs from device memory.
Every variant's output is held against the twin (bitwise, or its max
|diff| printed).  Beside them, the card's read floor (one ``torch.sum``
over as many f32 bytes as the bound counts, as cold), and the
host side: the wrappers' launch path as it stood before the redesign
(copied below) against the current one, both calling the repo's entry
point, the current one's parts each alone, and the two ways of reading
PyTorch's current stream.

  python3 tools/dissat_ablation.py [variant ...]          # one CUDA card, nvcc
  python3 tools/dissat_ablation.py --baseline OTHER.cu    # adds OTHER.cu's
                                                          # kernels as "baseline"
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dissatisfaction as D  # noqa: E402

# (B, N, K); B = 0 is kernel 1 (no batch axis)
SHAPES = ((0, 16384, 16), (0, 1_000_000, 8), (32, 4096, 16))
ROUNDS = 3
PEAK_BYTES_S = 3.35e12
COLD_BYTES = 200_000_000   # four times the H100's 50 MB L2

# every K stages its block's rows -- one contiguous slab of rows * K floats
# -- into shared memory with 16-byte loads, neighbouring threads on
# neighbouring vectors, at a row pitch of K | 1 (a warp's 32 rows in 32
# banks); each thread reduces its row from there.  The slab takes the
# default 48 KB of shared memory up to K = 93, more than this tool's K.
_STAGE_SLAB = """// Copies the n floats at src into dst, float j at row j / k,
// column j % k, with a row pitch of k | 1.
__device__ __forceinline__ void stage_slab(const float* __restrict__ src,
                                           int n, int k,
                                           float* __restrict__ dst) {
  const int pitch = k | 1;
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) &
                          15) / 4);
  const int n4 = (n - head) / 4;
  const float4* vec = reinterpret_cast<const float4*>(src + head);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const float4 v = __ldg(vec + q);
    const int j = head + 4 * q;
    dst[(j / k) * pitch + j % k] = v.x;
    dst[((j + 1) / k) * pitch + (j + 1) % k] = v.y;
    dst[((j + 2) / k) * pitch + (j + 2) % k] = v.z;
    dst[((j + 3) / k) * pitch + (j + 3) % k] = v.w;
  }
  for (int j = threadIdx.x; j < head; j += blockDim.x)
    dst[(j / k) * pitch + j % k] = __ldg(src + j);
  for (int j = head + 4 * n4 + threadIdx.x; j < n; j += blockDim.x)
    dst[(j / k) * pitch + j % k] = __ldg(src + j);
}

// Loads the KT floats of one row into registers."""
_STAGED = [
    ("// Loads the KT floats of one row into registers.", _STAGE_SLAB),
    ("""  float regs[kInRegisters<KT> ? KT : 1];
  const float* a_row = a.agg + i * k;
  if constexpr (kInRegisters<KT>) {
    if (live) load_row<KT>(a_row, regs);
    a_row = regs;
  }""", """  extern __shared__ float s_slab[];
  const int row0 = blockIdx.x * kRows;
  stage_slab(a.agg + (static_cast<size_t>(e) * a.rows + row0) * k,
             min(kRows, a.rows - row0) * k, k, s_slab);
  const float* a_row = s_slab + threadIdx.x * (k | 1);"""),
    ("<<<grid, kRows, 0, stream>>>",
     "<<<grid, kRows, sizeof(float) * kRows * (a.k | 1), stream>>>"),
]
# rows in registers, loaded float by float (no 16-byte loads)
_SCALAR_REGS = [("  if (KT % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) "
                 "== 0) {", "  if (false) {")]
# each thread reads its own row straight from device memory in both passes
# (the first design's access pattern, with K still a template constant)
_DIRECT = [("constexpr int kRegK = 32;", "constexpr int kRegK = 0;")]


def _rows(n):
    return [("constexpr int kRows = 128;", f"constexpr int kRows = {n};")]


# name -> (what it changes, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the source as it is: K <= 32 in registers by 16-byte loads, "
               "wider K read from device memory; template K", []),
    "staged": ("every K stages its block's slab in shared memory",
               _STAGED),
    "scalar_regs": ("rows in registers, loaded float by float",
                    _SCALAR_REGS),
    "direct": ("no registers: both passes read the row from device "
               "memory", _DIRECT),
    "rows_32": ("32 rows a block", _rows(32)),
    "rows_64": ("64 rows a block", _rows(64)),
    "rows_256": ("256 rows a block", _rows(256)),
    "runtime_k": ("every K on the runtime-K instance (device-memory "
                  "reads)",
                  [("  switch (a.k) {", "  switch (0) {")]),
}


def _variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"dissat_ablation: the source no longer holds "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _bind(path: Path) -> dict:
    lib = ctypes.CDLL(str(path))
    out = {}
    for name in ("dissat_from_aggregate", "dissat_from_aggregate_batched"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES["dissatisfaction"][name]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _build_all(texts: dict, out: Path) -> dict:
    """One library per distinct source text, all built in parallel."""
    procs, by_text = {}, {}
    for name, text in texts.items():
        if text in by_text:
            continue
        by_text[text] = name
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"dissat_ablation: {name} did not build\n{log}")
        regs = [line.strip() for line in log.splitlines() if "Used" in line]
        print(f"  [{name}] {len(regs)} kernels; registers: "
              f"{sorted({line.split('Used ')[1].split(' registers')[0] for line in regs}, key=int)}")
        built[name] = _bind(out / f"{name}.so")
    return {name: built[by_text[texts[name]]] for name in texts}


def _operands(bsz, n, k, seed=0):
    """A random operand set; B = 0 gives kernel 1's (no batch axis)."""
    rng = np.random.default_rng(seed)
    lead = (bsz,) if bsz else ()
    e = max(bsz, 1)
    agg = torch.as_tensor(rng.uniform(0, 50, lead + (n, k))
                          .astype(np.float32), device="cuda")
    r = torch.as_tensor(rng.integers(0, k, lead + (n,)).astype(np.int32),
                        device="cuda")
    b = torch.as_tensor(rng.uniform(0.1, 10, lead + (n,)).astype(np.float32),
                        device="cuda")
    sp = rng.uniform(0.5, 2.0, (e, k))
    speeds = torch.as_tensor((sp / sp.sum(axis=1, keepdims=True))
                             .astype(np.float32).reshape(lead + (k,)),
                             device="cuda")
    loads = torch.as_tensor(rng.uniform(0, 5 * n / k, lead + (k,))
                            .astype(np.float32), device="cuda")
    mu = torch.as_tensor(rng.choice([4.0, 8.0, 16.0], e).astype(np.float32)
                         .reshape(lead), device="cuda")
    total = (torch.stack([torch.sum(x) for x in b]) if bsz
             else torch.sum(b))
    return agg, r, b, loads, speeds, mu, total


def _nbytes(bsz, n, k) -> int:
    """Each input read once, each output written once (f32 and i32)."""
    e = max(bsz, 1)
    return 4 * (e * n * k + 2 * e * n + 2 * e * k + 2 * e + 2 * e * n)


def _cold(ops, nbytes):
    """``ops`` and copies of it, enough that cycling through them moves
    COLD_BYTES."""
    copies = max(1, math.ceil(COLD_BYTES / nbytes))
    return [ops] + [tuple(t.clone() for t in ops) for _ in range(copies - 1)]


def _cycling(fn, arg_sets):
    """A call of ``fn`` on the next of ``arg_sets`` each time."""
    nxt = [0]

    def call():
        nxt[0] = (nxt[0] + 1) % len(arg_sets)
        return fn(*arg_sets[nxt[0]])
    return call


def _launch_args(ops, out):
    agg, r, b, loads, speeds, mu, total = ops
    dissat, best = out
    bsz, n, k = (agg.shape if agg.ndim == 3 else (0, *agg.shape))
    ptrs = [agg.data_ptr(), r.data_ptr(), b.data_ptr(), None,
            loads.data_ptr(), speeds.data_ptr(), mu.data_ptr(),
            total.data_ptr(), dissat.data_ptr(), best.data_ptr()]
    ints = [bsz, n, k, 0] if bsz else [n, k, 0]
    stream = torch.cuda.current_stream().cuda_stream
    return ptrs + ints + [stream]


def _profiled_us(fn, args, reps=50):
    """Mean device time (us) of the dissat kernels launched by ``reps``
    calls, by torch.profiler; None when it recorded none."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "dissat_from_aggregate" in e.key
            and e.self_device_time_total > 0]
    count = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / count if count \
        else None


def _events_ms(fn, args, iters) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# the wrappers' launch path before the redesign, copied as it stood
# ---------------------------------------------------------------------------

def _old_check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _old_scalar(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _old_ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def old_kernel1_wrapper(aggregate, row_assignment, node_weights, loads,
                        speeds, mu, framework="c", *, theta=None,
                        total_weight=None):
    device = aggregate.device
    if device.type != "cuda":
        raise ValueError("dissatisfaction_from_aggregate_cuda needs CUDA "
                         "tensors")
    rows, k = aggregate.shape
    if not 1 <= k <= D.MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {D.MAX_K}; got K={k}")
    _old_check("aggregate", aggregate, torch.float32, (rows, k), device)
    _old_check("row_assignment", row_assignment, torch.int32, (rows,),
               device)
    _old_check("node_weights", node_weights, torch.float32, (rows,), device)
    _old_check("loads", loads, torch.float32, (k,), device)
    _old_check("speeds", speeds, torch.float32, (k,), device)
    if theta is not None:
        _old_check("theta", theta, torch.float32, (rows,), device)
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    mu_t = _old_scalar(mu, device)
    tb_t = _old_scalar(total_weight, device)
    dissat = torch.empty((rows,), dtype=torch.float32, device=device)
    best = torch.empty((rows,), dtype=torch.int32, device=device)
    if rows == 0:
        return dissat, best
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.dissat_from_aggregate(
        _old_ptr(aggregate), _old_ptr(row_assignment),
        _old_ptr(node_weights), _old_ptr(theta), _old_ptr(loads),
        _old_ptr(speeds), _old_ptr(mu_t), _old_ptr(tb_t), _old_ptr(dissat),
        _old_ptr(best), rows, k, D._FRAMEWORK_CODE[framework],
        ctypes.c_void_p(stream))
    D._raise_on(status, "dissat_from_aggregate")
    return dissat, best


def old_kernel3_wrapper(aggregate, row_assignment, node_weights, loads,
                        speeds, mu, framework="c", *, theta=None,
                        total_weight=None):
    device = aggregate.device
    if device.type != "cuda":
        raise ValueError("dissatisfaction_from_aggregate_batched_cuda needs "
                         "CUDA tensors")
    if aggregate.ndim != 3:
        raise ValueError(f"aggregate must be (B, rows, K); got shape "
                         f"{tuple(aggregate.shape)}")
    bsz, rows, k = aggregate.shape
    if not 1 <= k <= D.MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {D.MAX_K}; got K={k}")
    if not 1 <= bsz <= D.MAX_BATCH:
        raise ValueError(f"the kernel takes 1 <= B <= {D.MAX_BATCH}; got "
                         f"B={bsz}")
    _old_check("aggregate", aggregate, torch.float32, (bsz, rows, k), device)
    _old_check("row_assignment", row_assignment, torch.int32, (bsz, rows),
               device)
    _old_check("node_weights", node_weights, torch.float32, (bsz, rows),
               device)
    if total_weight is None:
        total_weight = torch.stack([torch.sum(b) for b in node_weights])
    _old_check("loads", loads, torch.float32, (bsz, k), device)
    _old_check("speeds", speeds, torch.float32, (bsz, k), device)
    _old_check("mu", mu, torch.float32, (bsz,), device)
    _old_check("total_weight", total_weight, torch.float32, (bsz,), device)
    if theta is not None:
        _old_check("theta", theta, torch.float32, (bsz, rows), device)
    dissat = torch.empty((bsz, rows), dtype=torch.float32, device=device)
    best = torch.empty((bsz, rows), dtype=torch.int32, device=device)
    if rows == 0:
        return dissat, best
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.dissat_from_aggregate_batched(
        _old_ptr(aggregate), _old_ptr(row_assignment),
        _old_ptr(node_weights), _old_ptr(theta), _old_ptr(loads),
        _old_ptr(speeds), _old_ptr(mu), _old_ptr(total_weight),
        _old_ptr(dissat), _old_ptr(best), bsz, rows, k,
        D._FRAMEWORK_CODE[framework], ctypes.c_void_p(stream))
    D._raise_on(status, "dissat_from_aggregate_batched")
    return dissat, best


def _host_us(fn, iters=2000) -> float:
    """Host microseconds per call of ``fn`` over back-to-back calls, with
    one sync at the end (the wrappers enqueue; the card keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / iters


def host_side(card: str) -> None:
    idx = torch.cuda.current_device()
    dev = torch.device("cuda", idx)
    print(f"host side: the launch path, microseconds per call by the host "
          f"clock over 2000 back-to-back calls, and by CUDA events [{card}]")
    reads = {
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(idx),
    }
    for name, fn in reads.items():
        t = [_host_us(fn, 20000) for _ in range(ROUNDS)]
        print(f"  stream read  {np.mean(t):8.3f} us  "
              f"({' '.join(f'{x:.3f}' for x in t)})  {name}")
    for bsz, n, k in ((0, 16384, 16), (32, 4096, 16)):
        ops = _operands(bsz, n, k)
        agg, r, b, loads, speeds, mu, total = ops
        if bsz:
            new, old, tag = (D.dissatisfaction_from_aggregate_batched_cuda,
                             old_kernel3_wrapper, "kernel 3")
            calls = {"old": (old, mu), "new": (new, mu)}
        else:
            new, old, tag = (D.dissatisfaction_from_aggregate_cuda,
                             old_kernel1_wrapper, "kernel 1")
            calls = {"old": (old, mu), "new": (new, mu),
                     "old, mu a float": (old, 8.0),
                     "new, mu a float": (new, 8.0)}
        want = new(agg, r, b, loads, speeds, mu, "c", total_weight=total)
        got = old(agg, r, b, loads, speeds, mu, "c", total_weight=total)
        torch.cuda.synchronize()
        if not (torch.equal(want[0], got[0]) and torch.equal(want[1],
                                                             got[1])):
            raise SystemExit("dissat_ablation: the old and new wrappers "
                             "differ")
        host = {name: [] for name in calls}
        events = {name: [] for name in calls}
        for order in (list(calls), list(reversed(calls)), list(calls)):
            for name in order:
                fn, m = calls[name]

                def call(fn=fn, m=m):
                    fn(agg, r, b, loads, speeds, m, "c", total_weight=total)
                host[name].append(_host_us(call))
                events[name].append(1e3 * _events_ms(lambda: call(), (),
                                                     2000))
        shape = f"(B, N, K)=({bsz}, {n}, {k})" if bsz else f"(N, K)=({n}, {k})"
        for name in calls:
            print(f"  {tag} {shape} wrapper {name:16s} host "
                  f"{np.mean(host[name]):8.3f} us "
                  f"({' '.join(f'{x:.3f}' for x in host[name])}), events "
                  f"{np.mean(events[name]):8.3f} us per call")
        # the new wrapper's parts, each alone, by the host clock
        entry = D._entry_point("dissat_from_aggregate_batched" if bsz
                               else "dissat_from_aggregate")
        cargs = _launch_args(ops, (torch.empty_like(b), torch.empty_like(r)))
        parts = {
            "operand checks": lambda: D.check_dissat_operands(
                agg, r, b, loads, speeds, None, mu if bsz else None,
                total if bsz else None, device=dev, batched=bool(bsz)),
            "two device scalars": lambda: (D._scalar(mu, dev),
                                           D._scalar(total, dev)),
            "two outputs (empty_like)": lambda: (torch.empty_like(b),
                                                 torch.empty_like(r)),
            "ten data_ptr()": lambda: [t.data_ptr() for t in (
                agg, r, b, loads, speeds, mu, total, b, r, agg)],
            "stream read": lambda: D._stream(dev),
            "C entry point (launch)": lambda: entry(*cargs),
        }
        for name, fn in parts.items():
            if bsz and name == "two device scalars":
                continue
            t = [_host_us(fn) for _ in range(ROUNDS)]
            print(f"    part {name:26s} {np.mean(t):8.3f} us "
                  f"({' '.join(f'{x:.3f}' for x in t)})")


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="*")
    parser.add_argument("--baseline", type=Path,
                        help="another dissatisfaction.cu with the same "
                             "entry points, timed as the variant 'baseline'")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dissat_ablation: needs a CUDA card")
    names = args.variants or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{list(VARIANTS)}")
    names = ["kernel"] + [n for n in names if n != "kernel"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = (_build.CSRC / "dissatisfaction.cu").read_text()
    texts = {name: _variant_source(src, VARIANTS[name][1]) for name in names}
    if args.baseline is not None:
        texts["baseline"] = args.baseline.read_text()
        names.append("baseline")
    with tempfile.TemporaryDirectory() as tmp:
        fns = _build_all(texts, Path(tmp))
        for bsz, n, k in SHAPES:
            ops = _operands(bsz, n, k)
            agg, r, b, loads, speeds, mu, total = ops
            byt = _nbytes(bsz, n, k)
            sets = _cold(ops, byt)
            twin = (D.dissatisfaction_from_aggregate_batched_plain if bsz
                    else D.dissatisfaction_from_aggregate_plain)
            want = twin(agg, r, b, loads, speeds, mu, "c",
                        total_weight=total)
            entry = ("dissat_from_aggregate_batched" if bsz
                     else "dissat_from_aggregate")
            calls, errs = {}, {}
            for name in names:
                out = (torch.full_like(b, float("nan")),
                       torch.full_like(r, -1))
                fn = fns[name][entry]
                cargs = [_launch_args(ops, out)] + [
                    _launch_args(x, (torch.empty_like(b),
                                     torch.empty_like(r))) for x in sets[1:]]
                if any(fn(*c) != 0 for c in cargs):
                    raise SystemExit(f"dissat_ablation: {name} did not "
                                     f"launch")
                torch.cuda.synchronize()
                same = torch.equal(out[0], want[0]) and torch.equal(
                    out[1], want[1])
                errs[name] = ("bitwise" if same else
                              f"max |diff| "
                              f"{float((out[0] - want[0]).abs().max()):.2e}, "
                              f"{int((out[1] != want[1]).sum())} best differ")
                calls[name] = (_cycling(fn, cargs), ())
            if errs["kernel"] != "bitwise":
                raise SystemExit(f"dissat_ablation: the kernel is not "
                                 f"bitwise its twin: {errs['kernel']}")
            bound = 1e3 * byt / PEAK_BYTES_S
            flats = [(torch.ones(byt // 4, dtype=torch.float32,
                                 device="cuda"),) for _ in sets]
            timed = dict(calls)
            timed["read"] = (_cycling(torch.sum, flats), ())
            iters = 50 if n * max(bsz, 1) * k > 4_000_000 else 400
            times = {name: [] for name in timed}
            for rnd in range(ROUNDS):
                order = list(timed) if rnd % 2 == 0 else list(timed)[::-1]
                for name in order:
                    fn, cargs = timed[name]
                    times[name].append(_events_ms(fn, cargs, iters))
            shape = (f"kernel 3 at (B, N, K)=({bsz}, {n}, {k})" if bsz else
                     f"kernel 1 at (N, K)=({n}, {k})")
            print(f"{shape}: bound {bound:.5f} ms (bytes, {byt / 1e6:.2f} "
                  f"MB); C entry-point calls in CUDA-event loops of {iters}, "
                  f"{ROUNDS} rounds in turns, and each kernel's device time "
                  f"by the profiler over 50 calls; {len(sets)} operand "
                  f"set(s) cycled [{card}]")
            prof = {name: _profiled_us(*calls[name]) for name in names}
            read = float(np.mean(times.pop("read")))
            print(f"  read floor  {read:.5f} ms  torch.sum over "
                  f"{(byt // 4) * 4 / 1e6:.2f} MB of f32: "
                  f"{(byt // 4) * 4 / read / 1e9:.3f} TB/s")
            for name in names:
                t = times[name]
                what = ("the other source" if name == "baseline"
                        else VARIANTS[name][0])
                dev = ("no profiler record" if prof[name] is None
                       else f"{prof[name]:.2f} us")
                print(f"  {name:13s} {np.mean(t):.5f} ms "
                      f"({' '.join(f'{x:.5f}' for x in t)})  bound share "
                      f"{bound / np.mean(t):.3f}  profiler {dev}  "
                      f"{errs[name]}  {what}")
            del ops, agg, sets, flats, calls, timed
            torch.cuda.empty_cache()
    host_side(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
