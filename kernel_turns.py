#!/usr/bin/env python3
"""Times the port's hand-written kernels on one card in turns, beyond what
`chip_smoke.py` times: each path of K3, K1 and K2's forward forced at the
shapes of the TwoWL and GCN paths (the numbers behind the dispatch
thresholds written in `csrc/spmm_bucketed.cu`, `csrc/spmm_ell.cu` and
`csrc/sddmm.cu`), and, with `--other`, this checkout's kernels against
another build of their sources at every shape of the kernel table in
`PERF.md`.

    python3 kernel_turns.py --groups check,paths,packed,split,k2,hoist
    python3 kernel_turns.py --groups compare \\
        --other build/parent/linkpred_tpu_torch/csrc

    python3 kernel_turns.py --groups cost --other-tree build/parent

`--other` names another revision's `csrc/` directory, for instance the
parent commit's, unpacked under `build/` (which git ignores):
`mkdir -p build/parent && git archive HEAD~1 linkpred_tpu_torch/csrc | tar
-x -C build/parent`. Its `spmm_ell.cu`, `spmm_bucketed.cu` and `sddmm.cu`
are built beside this checkout's and each shape is timed other, this, this,
other. Every time is the device ms per call of `chip_smoke.kernel_ms` (two
profiler captures that agree within 5 %); the variants of a shape are timed
in order and then in reverse, so each sees the card as warm as the others,
and the two turns are printed beside their mean. One JSON line per
measurement, the card's name and power limit first; `--out` appends them to
a file too.

The forced paths come from copies of this checkout's K3, K1 and K2 sources
under `build/kernel_turns/`, each with an entry point appended that launches
one kernel by name (`FORCE_K3`, `FORCE_K1`, `FORCE_K2`), and one K3 copy for
each value of `kSlotsUnroll` in `--unrolls` (the slot kernel) and of
`kPackedUnroll` in `--packed-unrolls` (the packed kernel). Groups: `check`
holds every forced kernel against the plain version; `paths` times K3's
slot kernel and K1's packed, wide and warp-per-row kernels at the narrow
shapes; `packed` times K3's packed kernel at each rows-a-warp beside the
wide and warp-per-row kernels, on rows of 16-256 bytes; `split` times K1's
split kernel at each warps a row beside K1's other kernels on fb-pages-food's
`[620, 114]` slots (and tiled to 4 and 16 times the rows); `k2` times K2's
packed forward at each rounds a warp beside the warp-per-edge kernel on the
GCN's pairs (`split` and `k2` hold each kernel against the plain version
first); `hoist` times the GCN's 60 training steps (steps/s, host clock)
with K2's gradient sorting its incidences in each backward, as the port
does, and with every step's order built once before the loop; `compare`
needs `--other`. `cost` (alone, with `--other-tree`, the root of another
revision's checkout unpacked under `build/`: `git archive HEAD~1 | tar -x
-C build/parent`) times the paths whose plain code between the kernels
sums rows: one child process per turn, other, this, this, other, each
importing its own tree's package (and building its kernels there), prints
SGNS steps/s and tokens/s at `chip_smoke.py` phase (u)'s shape, the
logistic family's total seconds (seed 35), SEAL's steps/s (seed 0, 10
epochs), TwoWL at 50k nodes' epochs/s (the full config) and
`par_collab`'s steps/s node-sharded and halo (four gloo ranks on the
card, through that tree's `chip_smoke._par_collab`). Needs a card and
`nvcc`; the data are the smoke's (fb-pages-food's TwoWL splits, TwoWL at
50k nodes, the collab-scale GCN graph and, for `packed` and `compare`, its
four-rank layouts), built on the host first.
"""

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from linkpred_tpu_torch.kernels import build
from linkpred_tpu_torch.ops import hopper_kernels as hk

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "linkpred_tpu_torch" / "csrc"
WORK = ROOT / "build" / "kernel_turns"
GROUPS = ("check", "paths", "packed", "split", "k2", "hoist", "compare",
          "cost")

# the `cost` group's child: run from the root of a checkout, it imports that
# tree's package and smoke, times the paths and prints one JSON line last
COST_CHILD = r"""
import contextlib, dataclasses, io, json, os, sys, tempfile, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from linkpred_tpu_torch.models import word2vec as w2v
from linkpred_tpu_torch.pipelines import gcn_scale as gs
from linkpred_tpu_torch.pipelines import logistic_pipeline as lp
from linkpred_tpu_torch.pipelines import seal_pipeline as sp
from linkpred_tpu_torch.pipelines import twowl_scale as ts
from linkpred_tpu_torch.utils.device import cuda_device

dev = cuda_device()
out = {"tree": os.getcwd()}

def synced():
    torch.cuda.synchronize(dev)
    return time.perf_counter()

# SGNS at phase (u)'s shape: a warm run, then two timed
n = 235_000
corpus = torch.as_tensor(np.random.default_rng(5).integers(
    0, n, (65_536, 16), dtype=np.int32), device=dev)
cfg = w2v.SGNSConfig(dim=128, epochs=1, batch_size=65_536)
prep = w2v.prepare_sgns(corpus, n, cfg)
steps = w2v.sgns_schedule(corpus.numel(), n, cfg)[1]
secs = []
for i in range(3):
    t0 = synced()
    w2v.train_sgns_device(torch.Generator(device=dev).manual_seed(i), corpus,
                          n, cfg, prep)
    secs.append(synced() - t0)
out["sgns_seconds"] = secs[1:]
out["sgns_steps_per_s"] = [steps / s for s in secs[1:]]
out["sgns_tokens_per_s"] = [corpus.numel() / s for s in secs[1:]]

with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(
        io.StringIO()):
    res = lp.run_logistic(
        lp.LogisticConfig(seed=35, records_dir=os.path.join(tmp, "rec")),
        device=dev, roc_png=None, metrics_file=os.path.join(tmp, "m.jsonl"))
    out["logistic_total_seconds"] = res["total_seconds"]
    out["logistic_auc"] = float(res["auc"])
    seal_cfg = sp.SEALConfig(seed=0, epochs=10,
                             records_dir=os.path.join(tmp, "rec"))
    res = sp.run_seal(seal_cfg, device=dev, verbose=False, roc_png=None,
                      metrics_file=os.path.join(tmp, "m.jsonl"),
                      checkpoint_prefix=None)
    # 4,182 subgraphs, 90 % of them trained in batches of 32
    steps = seal_cfg.epochs * (int(4182 * 0.9) // seal_cfg.batch_size)
    out["seal_steps_per_s"] = steps / res["train_seconds"]
    out["seal_auc"] = float(res["auc"])

res = ts.run_twowl_scale(ts.ScaleTwoWLConfig(), device=dev, verbose=False)
out["scale_epochs_per_s"] = res["epochs_per_s"]
out["scale_n2v_seconds"] = res["n2v_seconds"]
out["scale_test_auc"] = res["test_auc"]

gcfg = gs.ScaleGCNConfig(steps=60, learning_rate=3e-3)
gcfg_halo = dataclasses.replace(gcfg, aggregation="halo")
problem = gs.build_problem(gcfg)
built = [gs.build_sharded(c, cs.PAR_RANKS, problem) for c in (gcfg, gcfg_halo)]
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    cs._par_collab(dev, gcfg, gcfg_halo, problem, *built)
for line in printed.getvalue().splitlines():
    rec = json.loads(line) if line.startswith("{") else {}
    if rec.get("phase") == "par_collab":
        out[f"par_collab_{rec['aggregation']}_steps_per_s"] =             rec["steps_per_s"]
print(json.dumps(out))
"""

# kernel: 0 the warp-per-row kernel (feature pairs a lane where the rows
# allow them, as the dispatch takes it), 1 the slot kernel at `group` lanes a
# row (rows under 16 bytes), 2 the wide kernel, 3 the packed kernel at
# `group` lanes a slot and `rows` rows a warp (rows of whole 16-byte groups,
# `group` at least their count). Returns cudaErrorInvalidValue for a shape
# the kernel does not take.
FORCE_K3 = r"""
namespace {
template <typename T>
int force_packed(int group, int rows, const T* x, const int32_t* inv_perm,
                 const int32_t* order, const int32_t* nbr, const float* w,
                 T* out, int64_t n, int nx, int f, const Buckets& buckets,
                 cudaStream_t s) {
  if (!wide_aligned(f, sizeof(T), 16, {x, out}) ||
      static_cast<int64_t>(group) * 16 < f * static_cast<int64_t>(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PACKED(G, R)                                                        \
  if (group == G && rows == R) {                                            \
    launch_packed_rows<T, G, R>(x, inv_perm, order, nbr, w, out, n, nx, f,  \
                                buckets, s);                                \
    return static_cast<int>(cudaGetLastError());                           \
  }
  PACKED(1, 1) PACKED(1, 2) PACKED(1, 4) PACKED(1, 8) PACKED(1, 16)
  PACKED(1, 32)
  PACKED(2, 1) PACKED(2, 2) PACKED(2, 4) PACKED(2, 8) PACKED(2, 16)
  PACKED(4, 1) PACKED(4, 2) PACKED(4, 4) PACKED(4, 8)
  PACKED(8, 1) PACKED(8, 2) PACKED(8, 4)
  PACKED(16, 1) PACKED(16, 2)
#undef PACKED
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int force(int kernel, int group, int rows, const T* x,
          const int32_t* inv_perm, const int32_t* order, const int32_t* nbr,
          const float* w, T* out, int64_t n, int nx, int f,
          const Buckets& buckets, cudaStream_t s) {
  const int ni = static_cast<int>(n);
  if (kernel == 0) {
    const unsigned blocks =
        static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
    if (pairs_aligned(f, sizeof(T), {x, out})) {
      spmm_bucketed_kernel<T, 2><<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
          x, inv_perm, order, nbr, w, out, ni, nx, f, buckets);
    } else {
      spmm_bucketed_kernel<T, 1><<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
          x, inv_perm, order, nbr, w, out, ni, nx, f, buckets);
    }
  } else if (kernel == 1) {
    switch (group) {
      case 2: launch_slots_group<T, 2>(x, inv_perm, order, nbr, w, out, n,
                                       nx, f, buckets, s); break;
      case 4: launch_slots_group<T, 4>(x, inv_perm, order, nbr, w, out, n,
                                       nx, f, buckets, s); break;
      case 8: launch_slots_group<T, 8>(x, inv_perm, order, nbr, w, out, n,
                                       nx, f, buckets, s); break;
      case 16: launch_slots_group<T, 16>(x, inv_perm, order, nbr, w, out, n,
                                         nx, f, buckets, s); break;
      case 32: launch_slots_group<T, 32>(x, inv_perm, order, nbr, w, out, n,
                                         nx, f, buckets, s); break;
      default: launch_slots_group<T, 1>(x, inv_perm, order, nbr, w, out, n,
                                        nx, f, buckets, s);
    }
  } else if (kernel == 2) {
    if (!wide_aligned(f, sizeof(T), 16, {x, out})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int kTile = kWarp * FeatureIo<T>::kWide;
    const int64_t tiles = (f + kTile - 1) / kTile;
    const int64_t blocks = (n * tiles + kWideWarps - 1) / kWideWarps;
    spmm_bucketed_wide_kernel<T>
        <<<static_cast<unsigned>(blocks), kWarp * kWideWarps, 0, s>>>(
            x, inv_perm, order, nbr, w, out, ni, nx, f,
            static_cast<int>(tiles), buckets);
  } else {
    return force_packed<T>(group, rows, x, inv_perm, order, nbr, w, out, n,
                           nx, f, buckets, s);
  }
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int force_k3(int dtype, int kernel, int group, int rows,
                        const void* x, const int32_t* inv_perm,
                        const int32_t* order, const int32_t* nbr,
                        const float* w, void* out, int64_t n, int64_t nx,
                        int64_t f, int64_t n_buckets, const int64_t* shapes,
                        void* stream) {
  Buckets buckets{};
  buckets.count = static_cast<int>(n_buckets);
  int64_t rows_ = 0, slots = 0;
  for (int b = 0; b < buckets.count; ++b) {
    buckets.slot0[b] = slots;
    rows_ += shapes[2 * b];
    slots += shapes[2 * b] * shapes[2 * b + 1];
    buckets.row_end[b] = static_cast<int>(rows_);
    buckets.width[b] = static_cast<int>(shapes[2 * b + 1]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nxi = static_cast<int>(nx), fi = static_cast<int>(f);
  if (dtype == 0) {
    return force<float>(kernel, group, rows, static_cast<const float*>(x),
                        inv_perm, order, nbr, w, static_cast<float*>(out), n,
                        nxi, fi, buckets, s);
  }
  return force<__nv_bfloat16>(
      kernel, group, rows, static_cast<const __nv_bfloat16*>(x), inv_perm,
      order, nbr, w, static_cast<__nv_bfloat16*>(out), n, nxi, fi, buckets,
      s);
}
"""

# kernel: 0 the warp-per-row kernel, 1 the wide kernel, 2 the packed kernel,
# 3 the split kernel at the warps a row its launch picks, 4-7 the split
# kernel at 2, 4, 8 or 16 warps a row
FORCE_K1 = r'''
namespace {
template <int kGroup>
void force_split(int warps, const int32_t* nbr, const float* w,
                 const float* x, float* out, int64_t m, int64_t d,
                 int64_t nx, int64_t f, cudaStream_t s) {
  switch (warps) {
    case 2: launch_split_warps<kGroup, 2>(nbr, w, x, out, m, d, nx, f, s);
      break;
    case 4: launch_split_warps<kGroup, 4>(nbr, w, x, out, m, d, nx, f, s);
      break;
    case 8: launch_split_warps<kGroup, 8>(nbr, w, x, out, m, d, nx, f, s);
      break;
    case 16: launch_split_warps<kGroup, 16>(nbr, w, x, out, m, d, nx, f, s);
      break;
    default: launch_split<kGroup>(split_warps(m, d, f) > 0 ?
                                  split_warps(m, d, f) : 8, nbr, w, x, out,
                                  m, d, nx, f, s);
  }
}
}  // namespace

extern "C" int force_k1(int kernel, const int32_t* nbr, const float* w,
                        const float* x, float* out, int64_t m, int64_t d,
                        int64_t nx, int64_t f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m), di = static_cast<int>(d),
            nxi = static_cast<int>(nx), fi = static_cast<int>(f);
  if (kernel == 0) {
    const unsigned blocks =
        static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
    spmm_ell_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
        nbr, w, x, out, mi, di, nxi, fi);
  } else if (kernel == 1) {
    const int64_t tiles = (f + kTile - 1) / kTile;
    spmm_ell_wide_kernel<<<static_cast<unsigned>(m * tiles), kWarp * kSplit,
                           0, s>>>(nbr, w, x, out, di, nxi, fi,
                                   static_cast<int>(tiles));
  } else if (kernel >= 3) {
    const int warps = kernel == 3 ? 0 : 1 << (kernel - 3);
    const int64_t groups = f / 4;
    if (groups <= 1) force_split<1>(warps, nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 2) force_split<2>(warps, nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 4) force_split<4>(warps, nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 8) force_split<8>(warps, nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 16) {
      force_split<16>(warps, nbr, w, x, out, m, d, nx, f, s);
    } else {
      force_split<32>(warps, nbr, w, x, out, m, d, nx, f, s);
    }
  } else {
    const int64_t groups = f / 4;
    if (groups <= 1) launch_packed<1>(nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 2) launch_packed<2>(nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 4) launch_packed<4>(nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 8) launch_packed<8>(nbr, w, x, out, m, d, nx, f, s);
    else if (groups <= 16) launch_packed<16>(nbr, w, x, out, m, d, nx, f, s);
    else launch_packed<32>(nbr, w, x, out, m, d, nx, f, s);
  }
  return static_cast<int>(cudaGetLastError());
}
'''

# kernel: 0 the warp-per-edge kernel, 1 the packed kernel at `rounds` rounds
# a warp (1, 2 or 4; rows of whole 16-byte groups, at most 32 of them)
FORCE_K2 = r'''
namespace {
template <typename T>
int force2(int kernel, int rounds, const int32_t* src, const int32_t* dst,
           const T* x, const T* y, float* out, int64_t e, int64_t nx,
           int64_t ny, int64_t f, cudaStream_t s) {
  if (kernel == 0) {
    const unsigned blocks =
        static_cast<unsigned>((e + kWarpsPerBlock - 1) / kWarpsPerBlock);
    if (pairs_aligned(f, sizeof(T), {x, y})) {
      sddmm_kernel<T, 2><<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
          src, dst, x, y, out, e, nx, ny, f);
    } else {
      sddmm_kernel<T, 1><<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
          src, dst, x, y, out, e, nx, ny, f);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t groups = f * static_cast<int64_t>(sizeof(T)) / 16;
  if (!wide_aligned(f, sizeof(T), 16, {x, y}) || groups > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define ROUNDS(G)                                                          \
  if (groups <= G) {                                                       \
    constexpr int kAt = kWarp / G;                                         \
    if (rounds == 4 && kAt * 4 <= kWarp) {                                 \
      launch_packed_rounds<T, G, (kAt * 4 <= kWarp ? 4 : 1), 1>(           \
          src, dst, x, y, out, e, nx, ny, f, s);                           \
    } else if (rounds == 2 && kAt * 2 <= kWarp) {                          \
      launch_packed_rounds<T, G, (kAt * 2 <= kWarp ? 2 : 1), 1>(           \
          src, dst, x, y, out, e, nx, ny, f, s);                           \
    } else if (rounds == 1) {                                              \
      launch_packed_rounds<T, G, 1, 1>(src, dst, x, y, out, e, nx, ny, f,  \
                                       s);                                 \
    } else {                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    return static_cast<int>(cudaGetLastError());                           \
  }
  ROUNDS(1) ROUNDS(2) ROUNDS(4) ROUNDS(8) ROUNDS(16) ROUNDS(32)
#undef ROUNDS
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" int force_k2(int dtype, int kernel, int rounds,
                        const int32_t* src, const int32_t* dst,
                        const void* x, const void* y, float* out, int64_t e,
                        int64_t nx, int64_t ny, int64_t f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return force2<float>(kernel, rounds, src, dst,
                         static_cast<const float*>(x),
                         static_cast<const float*>(y), out, e, nx, ny, f, s);
  }
  return force2<__nv_bfloat16>(
      kernel, rounds, src, dst, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(y), out, e, nx, ny, f, s);
}
'''

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
UNROLL_LINE = "constexpr int kSlotsUnroll = {};"
PACKED_UNROLL_LINE = "constexpr int kPackedUnroll = {};"
# rows of 16-256 bytes, the widths at which K3's packed kernel competes
PACKED_WIDTHS = tuple((f, torch.bfloat16) for f in (8, 16, 32, 64, 128)) + \
    tuple((f, torch.float32) for f in (4, 8, 16, 32, 64))


def packed_variants(f, dtype):
    """K3's packed kernel at `f` features of `dtype`: label -> (kernel,
    group, rows) for `force_k3`, its group the row's 16-byte groups rounded
    up to a power of two, at each rows-a-warp that leaves a row a group."""
    groups = f * torch.tensor([], dtype=dtype).element_size() // 16
    group = 1 << max(groups - 1, 0).bit_length()
    return {f"packed G={group} rows={r}": (3, group, r)
            for r in (1, 2, 4, 8, 16, 32) if group * r <= 32}


class Out:
    """One JSON line per measurement on stdout, and in `path` if given."""

    def __init__(self, path):
        self.path = Path(path) if path else None

    def __call__(self, **kv):
        line = json.dumps(kv)
        print(line, flush=True)
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a") as fh:
                fh.write(line + "\n")


def _nvcc(src: Path, out: Path) -> tuple[Path, str]:
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


def registers(log, part):
    """Registers a thread of each kernel whose (mangled) name holds `part`,
    from a ptxas report: name -> count."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if part in line else None
        elif name is not None and "Used" in line and "registers" in line:
            found[name] = int(line.split("Used")[1].split()[0])
            name = None
    return found


def build_variants(unrolls, packed_unrolls, other):
    """The forced-path copies of this checkout's sources (one K3 copy per
    slot-kernel unroll, one per other packed-kernel unroll) and, with
    `other`, the other revision's K1, K3 and K2, all built at once beside
    this checkout's own kernels. Returns (name -> loaded entry point with
    its types declared, the default unrolls, name -> packed kernels'
    registers a thread)."""
    src_dir, lib_dir = WORK / "src", WORK / "lib"
    src_dir.mkdir(parents=True, exist_ok=True)
    lib_dir.mkdir(parents=True, exist_ok=True)
    (src_dir / "feature_io.cuh").write_text(
        (CSRC / "feature_io.cuh").read_text())
    k3 = (CSRC / "spmm_bucketed.cu").read_text()
    default = next(u for u in range(1, 65) if UNROLL_LINE.format(u) in k3)
    default_packed = next(u for u in range(1, 65)
                          if PACKED_UNROLL_LINE.format(u) in k3)
    jobs = {}
    for u in unrolls:
        p = src_dir / f"k3_unroll{u}.cu"
        p.write_text(k3.replace(UNROLL_LINE.format(default),
                                UNROLL_LINE.format(u)) + FORCE_K3)
        jobs[f"k3 unroll {u}"] = p
    for u in set(packed_unrolls) - {default_packed}:
        p = src_dir / f"k3_packed_unroll{u}.cu"
        p.write_text(k3.replace(PACKED_UNROLL_LINE.format(default_packed),
                                PACKED_UNROLL_LINE.format(u)) + FORCE_K3)
        jobs[f"k3 packed unroll {u}"] = p
    p = src_dir / "k1.cu"
    p.write_text((CSRC / "spmm_ell.cu").read_text() + FORCE_K1)
    jobs["k1"] = p
    p = src_dir / "k2.cu"
    p.write_text((CSRC / "sddmm.cu").read_text() + FORCE_K2)
    jobs["k2"] = p
    if other is not None:
        for name in ("spmm_ell", "spmm_bucketed", "sddmm"):
            jobs[f"other {name}"] = Path(other) / f"{name}.cu"
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        own = pool.submit(build.libraries, ("spmm_ell", "spmm_bucketed",
                                            "sddmm", "empty_launch"))
        done = {k: pool.submit(_nvcc, src, lib_dir / f"{k.replace(' ', '_')}.so")
                for k, src in jobs.items()}
        built = {k: f.result() for k, f in done.items()}
        own.result()
    libs = {k: ctypes.CDLL(str(path)) for k, (path, _) in built.items()}
    regs = {k: registers(log, "packed") for k, (_, log) in built.items()
            if k.startswith("k3")}
    entries = {}
    for k in libs:
        if k.startswith("k3"):
            fn = libs[k].force_k3
            fn.argtypes = [_I32] * 4 + [_P] * 6 + [_I64] * 4 + [_P, _P]
            entries[k] = fn
    fn = libs["k1"].force_k1
    fn.argtypes = [_I32] + [_P] * 4 + [_I64] * 4 + [_P]
    entries["k1"] = fn
    fn = libs["k2"].force_k2
    fn.argtypes = [_I32] * 3 + [_P] * 5 + [_I64] * 4 + [_P]
    entries["k2"] = fn
    for name in ("spmm_ell", "spmm_bucketed", "sddmm"):
        symbol, argtypes = hk._ENTRY_POINTS[name]
        entries[f"this {name}"] = fn = getattr(build.library(name), symbol)
        fn.argtypes = argtypes
        if other is not None:
            fn = getattr(libs[f"other {name}"], symbol)
            fn.argtypes = argtypes
            entries[f"other {name}"] = fn
    for fn in entries.values():
        fn.restype = _I32
    return entries, (default, default_packed), regs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def k3_call(fn, x, k3, kernel=None):
    """K3 through `fn`: a public entry (`kernel` None) or `force_k3`, with
    `kernel` its (kernel, group, rows)."""
    inv_perm, shapes, nbr, w = k3[:4]
    order = k3[4] if len(k3) > 4 else None
    n, (nx, f) = inv_perm.shape[0], x.shape
    table = (ctypes.c_int64 * (2 * len(shapes)))(
        *(v for shape in shapes for v in shape))
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    head = (hk._DTYPE_CODES[x.dtype],)
    if kernel is not None:
        head += tuple(kernel)
    rc = fn(*head, x.data_ptr(), inv_perm.data_ptr(),
            None if order is None else order.data_ptr(), nbr.data_ptr(),
            w.data_ptr(), out.data_ptr(), n, nx, f, len(shapes),
            ctypes.addressof(table), _stream())
    assert rc == 0, f"K3 launch refused: {rc}"
    return out


def k1_call(fn, nbr, w, x, kernel=None):
    """K1 through `fn`: a public entry (`kernel` None) or `force_k1`."""
    (m, d), (nx, f) = nbr.shape, x.shape
    out = torch.empty((m, f), device=x.device)
    head = () if kernel is None else (kernel,)
    rc = fn(*head, nbr.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(),
            m, d, nx, f, _stream())
    assert rc == 0, f"K1 launch refused: {rc}"
    return out


def k2_call(fn, src, dst, x, y, kernel=None):
    """K2 through `fn`: a public entry (`kernel` None) or `force_k2`, with
    `kernel` its (kernel, rounds)."""
    e, (nx, f), ny = src.shape[0], x.shape, y.shape[0]
    out = torch.empty(e, device=x.device)
    head = (hk._DTYPE_CODES[x.dtype],)
    if kernel is not None:
        head += tuple(kernel)
    rc = fn(*head, src.data_ptr(), dst.data_ptr(), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), e, nx, ny, f, _stream())
    assert rc == 0, f"K2 launch refused: {rc}"
    return out


def turns(fns):
    """Device ms per call of each of `fns`, timed in order and then in
    reverse: (name -> mean, name -> [first turn, second turn])."""
    got = {k: [] for k in fns}
    for k in [*fns, *reversed(list(fns))]:
        got[k].append(cs.kernel_ms(fns[k]))
    return {k: sum(v) / 2 for k, v in got.items()}, got


def layouts(dev, need_sharded):
    """The K3 operands of the paths, by name -> (k3 tuple, rows of x), and
    K1's slot matrices by name -> (nbr, w, rows of x)."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import spmm
    from linkpred_tpu_torch.pipelines import gcn_scale as gs
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    run = tp.TwoWLRunConfig()
    edges, num_nodes = tp.load_edges()
    data = tp.build_data(edges, num_nodes, run, np.random.default_rng(0))
    trn, val, tst = (m.SplitArrays.from_split(s, dev)
                     for s in (data.train, data.val, data.test))
    scale = m.SplitArrays.from_split(
        ts.build_scale_data(ts.ScaleTwoWLConfig()).train, dev)
    cfg = gs.ScaleGCNConfig(steps=60, learning_rate=3e-3)
    problem = gs.build_problem(cfg)
    k3 = {"50k fwd": (scale.e1_cops[0].k3, scale.num_rows),
          "50k bwd": (scale.e1_cops[1].k3, scale.num_rows),
          "fb train fwd": (trn.e1_cops[0].k3, trn.num_rows),
          "fb train bwd": (trn.e1_cops[1].k3, trn.num_rows),
          "fb val fwd": (val.e1_cops[0].k3, val.num_rows),
          "fb test fwd": (tst.e1_cops[0].k3, tst.num_rows),
          "gcn": (spmm.BucketedEll.from_graph(problem[0]).operands(dev),
                  cfg.nodes)}
    if need_sharded:
        from linkpred_tpu_torch.parallel import spmm_shard

        ns = gs.build_sharded(cfg, cs.PAR_RANKS, problem)
        halo = gs.build_sharded(
            dataclasses.replace(cfg, aggregation="halo"), cs.PAR_RANKS,
            problem)
        k3["node-sharded rank 0"] = (spmm_shard.node_sharded_operands(
            ns["stacked"], 0, dev), cfg.nodes)
        k3["halo rank 0"] = (tuple(halo["layout"].operands(0, dev).k3),
                             len(cs._halo_table_rows(halo["layout"], 0)))
    k1 = {"fb train": (trn.msg_slots, trn.msg_sweight, trn.num_msg),
          "50k": (scale.msg_slots, scale.msg_sweight, scale.num_msg)}
    # K2's pairs: a training step's (the first batch), the test pairs, and
    # a rank's scoring of the step over its gathered rows (pair e is rows e
    # and E + e of the gathered table)
    _, train_pos, test_pos, test_neg = problem
    step = torch.from_numpy(gs.batch_schedule(cfg, train_pos)[0]).to(dev)
    test = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([test_pos, test_neg]).astype(np.int32).T)).to(dev)
    ids = torch.arange(step.shape[1], device=dev, dtype=torch.int32)
    k2 = {"step": (step[0], step[1], cfg.nodes),
          "test": (test[0], test[1], cfg.nodes),
          "rank": (ids, ids + step.shape[1], 2 * step.shape[1])}
    return k3, k1, k2, (cfg, problem)


def cost_turns(other: Path, emit):
    """The `cost` group: `COST_CHILD` in `other` and in this checkout, in
    turns other, this, this, other, one process each; one line per turn,
    then each tree's mean of every number over its two turns."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    emit(step="cost", device=smi, other=str(other), this=str(ROOT))
    turns = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        tree = other if label == "other" else ROOT
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", COST_CHILD], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cost child in {tree} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns[label].append(res)
        emit(step="cost_turn", build=label, seconds=time.perf_counter() - t0,
             **res)
    for label, runs in turns.items():
        mean = {k: float(np.mean([np.mean(r[k]) for r in runs]))
                for k, v in runs[0].items()
                if isinstance(v, (int, float, list))}
        emit(step="cost_mean", build=label, device=smi, **mean)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--groups", default="check,paths",
                        help="comma-separated: " + ", ".join(GROUPS))
    parser.add_argument("--other", default=None,
                        help="another revision's csrc/ directory, for "
                             "the compare group")
    parser.add_argument("--unrolls", default="4,8,16",
                        help="values of K3's kSlotsUnroll to build")
    parser.add_argument("--packed-unrolls", default="8",
                        help="values of K3's kPackedUnroll to build")
    parser.add_argument("--other-tree", default=None,
                        help="another revision's checkout root, for the "
                             "cost group")
    parser.add_argument("--out", default=None,
                        help="a file to append the JSON lines to")
    args = parser.parse_args()
    groups = args.groups.split(",")
    if not set(groups) <= set(GROUPS):
        parser.error(f"unknown groups {sorted(set(groups) - set(GROUPS))}")
    if "compare" in groups and not args.other:
        parser.error("the compare group needs --other")
    if "cost" in groups and (groups != ["cost"] or not args.other_tree):
        parser.error("the cost group runs alone, with --other-tree")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: no CUDA device is visible")
    from linkpred_tpu_torch.utils.device import cuda_device

    emit = Out(args.out)
    if groups == ["cost"]:
        cost_turns(Path(args.other_tree).resolve(), emit)
        return
    dev = cuda_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    unrolls = [int(u) for u in args.unrolls.split(",")]
    t0 = time.perf_counter()
    packed_unrolls = [int(u) for u in args.packed_unrolls.split(",")]
    entries, (default_unroll, default_packed), regs = build_variants(
        unrolls, packed_unrolls, args.other)
    emit(step="build", device=smi, default_unroll=default_unroll,
         default_packed_unroll=default_packed, packed_registers=regs,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    k3_layouts, k1_layouts, k2_pairs, gcn = layouts(
        dev, "compare" in groups or "packed" in groups)
    emit(step="data", seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.float32: cs.F32_TOL, torch.bfloat16: cs.BF16_TOL}
    bf16, f32 = torch.bfloat16, torch.float32
    slot_groups = (1, 2, 4, 8, 16, 32)

    def feats(rows, f, dtype=f32):
        return torch.randn((rows, f), generator=gen, device=dev).to(dtype)

    def k2_variants(src, dst, f, dtype):
        """K2's forward kernels at `f` features of `dtype`: label ->
        callable(x, y), the packed kernel at each rounds a warp that keeps
        a warp's edges within 32."""
        groups = f * torch.tensor([], dtype=dtype).element_size() // 16
        at_once = 32 // min(32, 1 << max(groups - 1, 0).bit_length())
        out = {"public": lambda x, y: k2_call(entries["this sddmm"], src,
                                              dst, x, y),
               "warp per edge": lambda x, y: k2_call(entries["k2"], src, dst,
                                                     x, y, (0, 1))}
        for r in (1, 2, 4):
            if groups <= 32 and at_once * r <= 32:
                out[f"rounds {r}"] = (lambda r=r: lambda x, y: k2_call(
                    entries["k2"], src, dst, x, y, (1, r)))()
        return out

    def force3(u, kernel, group=0, rows=1):
        return lambda x, k3: k3_call(entries[f"k3 unroll {u}"], x, k3,
                                     (kernel, group, rows))

    def packed(f, dtype):
        """The packed kernel's variants at `f` features of `dtype`, at
        every packed unroll built: label -> callable(x, k3)."""
        out = {}
        for pu in packed_unrolls:
            lib = (f"k3 unroll {default_unroll}" if pu == default_packed
                   else f"k3 packed unroll {pu}")
            for k, v in packed_variants(f, dtype).items():
                label = k if pu == default_packed else f"{k} unroll {pu}"
                out[label] = (lambda v=v, lib=lib: lambda x, k3: k3_call(
                    entries[lib], x, k3, v))()
        return out

    if "check" in groups:
        # every forced K3 and K1 kernel against the plain version
        for name, (k3, rows) in k3_layouts.items():
            for f, dtype in ((1, f32), (3, f32), (7, bf16), *PACKED_WIDTHS):
                x = feats(rows, f, dtype)
                ref = hk.spmm_bucketed_reference(x, *k3)
                kernels = {"public": lambda x, k3: k3_call(
                    entries["this spmm_bucketed"], x, k3),
                           "warp per row": force3(unrolls[0], 0)}
                if f * x.element_size() < 16:
                    for u in unrolls:
                        for g in slot_groups:
                            kernels[f"slots G={g} unroll {u}"] = force3(
                                u, 1, g)
                else:
                    kernels["wide"] = force3(unrolls[0], 2)
                    kernels.update(packed(f, dtype))
                err = max(cs.check(f"{name} F={f} {k}", fn(x, k3), ref,
                                   tol[dtype]) for k, fn in kernels.items())
                emit(step="check K3", layout=name, f=f, dtype=str(dtype),
                     max_abs_err=err)
        for name, (nbr, w, nx) in k1_layouts.items():
            for f in (4, 16, 24, 64, 128):
                x = feats(nx, f)
                ref = hk.spmm_ell_reference(nbr, w, x)
                err = max(cs.check(f"K1 {name} F={f} kernel {k}",
                                   k1_call(entries["k1"], nbr, w, x, k), ref,
                                   dict(rtol=1e-5, atol=5e-5))
                          for k in range(8))
                emit(step="check K1", layout=name, f=f, max_abs_err=err)
        for name, (src, dst, n) in k2_pairs.items():
            for f, dtype in ((128, bf16), (64, bf16), (32, bf16),
                             (128, f32), (8, bf16), (256, bf16)):
                x, y = feats(n, f, dtype), feats(n, f, dtype)
                ref = hk.sddmm_reference(src, dst, x, y)
                err = max(cs.check(f"K2 {name} F={f} {k}", fn(x, y), ref,
                                   cs.K2_TOL)
                          for k, fn in k2_variants(src, dst, f, dtype).items())
                emit(step="check K2", pairs=name, f=f, dtype=str(dtype),
                     max_abs_err=err)

    if "paths" in groups:
        # K3 at F = 1 f32: every group and unroll of the slot kernel, the
        # warp-per-row kernel and the public dispatch
        for name, (k3, rows) in k3_layouts.items():
            if name.endswith("rank 0"):
                continue
            x = feats(rows, 1)
            fns = {"public": lambda: k3_call(entries["this spmm_bucketed"],
                                             x, k3),
                   "warp per row": lambda: force3(default_unroll, 0)(x, k3)}
            for u in unrolls:
                for g in slot_groups:
                    fns[f"G={g} unroll {u}"] = (
                        lambda u=u, g=g: force3(u, 1, g)(x, k3))
            mean, raw = turns(fns)
            emit(step="K3 slot kernel F=1 f32", layout=name, rows=rows,
                 buckets=[list(b) for b in k3[1]],
                 fastest=min(mean, key=mean.get), ms=mean, turns=raw)
        # the other rows under 16 bytes, at the default unroll
        for name in ("50k fwd", "gcn", "fb train fwd"):
            k3, rows = k3_layouts[name]
            for f, dtype in ((2, f32), (3, f32), (1, bf16), (2, bf16),
                             (4, bf16), (7, bf16)):
                x = feats(rows, f, dtype)
                fns = {"public": lambda: k3_call(
                    entries["this spmm_bucketed"], x, k3),
                       "warp per row": lambda: force3(default_unroll, 0)(
                           x, k3)}
                for g in slot_groups[:-1]:
                    fns[f"G={g}"] = lambda g=g: force3(default_unroll, 1, g)(
                        x, k3)
                mean, raw = turns(fns)
                emit(step="K3 slot kernel", layout=name, f=f,
                     dtype=str(dtype), fastest=min(mean, key=mean.get),
                     ms=mean, turns=raw)
        # K1: the packed, wide and warp-per-row kernels on fb-pages-food's
        # slots (D = 114) tiled to more rows, and on the 50k-node slots
        # (D = 32) doubled in width
        nbr0, w0, nx0 = k1_layouts["fb train"]
        nbr1, w1, nx1 = k1_layouts["50k"]
        shapes = [(f"fb x{r}", nbr0.repeat(r, 1), w0.repeat(r, 1), nx0, f)
                  for r in (1, 4, 16, 80) for f in (4, 16, 24, 32, 64, 128)]
        shapes += [(f"50k D={32 * r}", nbr1.repeat(1, r).contiguous(),
                    w1.repeat(1, r).contiguous(), nx1, f)
                   for r in (1, 2, 4) for f in (16, 24, 64, 128)]
        for name, nbr, w, nx, f in shapes:
            x = feats(nx, f)
            fns = {"public": lambda: k1_call(entries["this spmm_ell"], nbr,
                                             w, x)}
            for k, label in enumerate(("warp per row", "wide", "packed")):
                fns[label] = lambda k=k: k1_call(entries["k1"], nbr, w, x, k)
            mean, raw = turns(fns)
            emit(step="K1 kernels", layout=name, nbr=list(nbr.shape), f=f,
                 fastest=min(mean, key=mean.get), ms=mean, turns=raw)

    if "packed" in groups:
        # K3 on rows of 16-256 bytes: the packed kernel at each rows-a-warp
        # it takes, the wide and warp-per-row kernels and the dispatch, at
        # every such width on three layouts and at the paths' own shapes on
        # the rest
        shapes = [(name, f, dtype) for name in ("50k fwd", "gcn",
                                                "fb train fwd")
                  for f, dtype in PACKED_WIDTHS]
        shapes += [("50k bwd", 32, bf16)] + [
            (name, f, bf16) for name in ("node-sharded rank 0",
                                         "halo rank 0") for f in (64, 128)]
        for name, f, dtype in shapes:
            k3, rows = k3_layouts[name]
            x = feats(rows, f, dtype)
            fns = {"public": lambda: k3_call(entries["this spmm_bucketed"],
                                             x, k3)}
            variants = {"warp per row": force3(default_unroll, 0),
                        "wide": force3(default_unroll, 2), **packed(f, dtype)}
            for k, fn in variants.items():
                fns[k] = lambda fn=fn: fn(x, k3)
            mean, raw = turns(fns)
            emit(step="K3 packed kernel", layout=name, rows=rows,
                 output_rows=int(k3[0].shape[0]), f=f, dtype=str(dtype),
                 fastest=min(mean, key=mean.get), ms=mean, turns=raw)

    if "split" in groups:
        # K1 on fb-pages-food's slots (D = 114, one hub row of 114 live
        # slots): the split kernel at each warps a row and at its launch's
        # pick, beside the wide, packed and warp-per-row kernels and the
        # dispatch, at every width K1 meets and the same slots tiled to 4
        # and 16 times the rows; each kernel first held to the plain version
        nbr0, w0, nx0 = k1_layouts["fb train"]
        shapes = [("fb", nbr0, w0, f) for f in (4, 16, 24, 32, 64, 128, 192,
                                                  256, 512, 768)]
        shapes += [(f"fb x{r}", nbr0.repeat(r, 1), w0.repeat(r, 1), f)
                   for r in (4, 16) for f in (16, 24, 192, 512)]
        labels = {0: "warp per row", 1: "wide", 2: "packed", 3: "split",
                  4: "split W=2", 5: "split W=4", 6: "split W=8",
                  7: "split W=16"}
        for name, nbr, w, f in shapes:
            x = feats(nx0, f)
            ref = hk.spmm_ell_reference(nbr, w, x)
            fns = {"public": lambda: k1_call(entries["this spmm_ell"], nbr,
                                             w, x)}
            for k, label in labels.items():
                if k != 2 or f // 4 <= 32:
                    fns[label] = lambda k=k: k1_call(entries["k1"], nbr, w,
                                                     x, k)
            err = max(cs.check(f"K1 {name} F={f} {k}", fn(), ref,
                               dict(rtol=1e-5, atol=5e-5))
                      for k, fn in fns.items())
            mean, raw = turns(fns)
            emit(step="K1 split kernel", layout=name, nbr=list(nbr.shape),
                 f=f, max_abs_err=err, fastest=min(mean, key=mean.get),
                 ms=mean, turns=raw)

    if "k2" in groups:
        # K2's forward: the packed kernel at each rounds a warp beside the
        # warp-per-edge kernel and the dispatch, on the GCN's pairs; each
        # kernel first held to the plain version
        for name, f, dtype in [("step", 128, bf16), ("test", 128, bf16),
                               ("rank", 128, bf16), ("step", 64, bf16),
                               ("step", 128, f32), ("step", 32, bf16),
                               ("test", 32, bf16)]:
            src, dst, n = k2_pairs[name]
            x = feats(n, f, dtype)
            ref = hk.sddmm_reference(src, dst, x, x)
            variants = k2_variants(src, dst, f, dtype)
            err = max(cs.check(f"K2 {name} F={f} {k}", fn(x, x), ref,
                               cs.K2_TOL) for k, fn in variants.items())
            mean, raw = turns({k: (lambda fn=fn: fn(x, x))
                               for k, fn in variants.items()})
            emit(step="K2 packed kernel", pairs=name, e=int(src.shape[0]),
                 f=f, dtype=str(dtype), max_abs_err=err,
                 fastest=min(mean, key=mean.get), ms=mean, turns=raw)

    if "hoist" in groups:
        # the GCN's steps scored by `sddmm_coo` (its backward sorts the
        # step's incidences) and by the same kernels with every step's
        # order built before the loop (`Ahead`), in turns (sorted, ahead,
        # ahead, sorted) three times, each run from the same parameters
        # and ending in a sync
        from linkpred_tpu_torch.ops import sddmm as sd
        from linkpred_tpu_torch.ops import spmm
        from linkpred_tpu_torch.pipelines import gcn_scale as gs

        cfg, problem = gcn
        ops = k3_layouts["gcn"][0]
        batches = torch.from_numpy(gs.batch_schedule(cfg, problem[1])).to(dev)

        class Ahead(torch.autograd.Function):
            @staticmethod
            def forward(ctx, src, dst, h, order):
                ctx.save_for_backward(src, dst, h, order)
                return hk.sddmm(src, dst, h, h)

            @staticmethod
            def backward(ctx, g):
                src, dst, h, order = ctx.saved_tensors
                return None, None, hk.sddmm_grad(
                    g.float().contiguous(), src, dst, h, None, order)[0], None

        def steps_per_s(ahead):
            params = gs.init_params(
                cfg, torch.Generator().manual_seed(cfg.seed), dev)
            opt = gs.adam(params, cfg.learning_rate)
            torch.cuda.synchronize()
            t = time.perf_counter()
            score = sd.sddmm_coo
            if ahead:
                orders = iter(hk.incidence_order(batches[:, 0], batches[:, 1]))
                score = lambda s, d, h: Ahead.apply(  # noqa: E731
                    s, d, h, next(orders)).to(h.dtype)
            gs.train_steps(params, opt, batches, ops, cfg,
                           spmm.spmm_bucketed_sym, score)
            torch.cuda.synchronize()
            return batches.shape[0] / (time.perf_counter() - t)

        steps_per_s(False), steps_per_s(True)  # warm-up
        rates = {"sorted": [], "ahead": []}
        for _ in range(3):
            for name in ("sorted", "ahead", "ahead", "sorted"):
                rates[name].append(steps_per_s(name == "ahead"))
        mean = {k: sum(v) / len(v) for k, v in rates.items()}
        emit(step="K2 gradient order", steps=int(batches.shape[0]),
             steps_per_s=mean, ahead_over_sorted=mean["ahead"]
             / mean["sorted"], turns=rates)

    if "compare" in groups:
        # the other build against this one at every shape of the kernel
        # table: K3 ...
        k3_shapes = [("fb train fwd", f, f32) for f in (1, 32, 256, 1024)]
        k3_shapes += [("fb train fwd", 1024, bf16), ("fb train bwd", 1, f32),
                      ("fb train bwd", 32, f32), ("fb val fwd", 1, f32),
                      ("fb test fwd", 1, f32), ("gcn", 64, bf16),
                      ("gcn", 128, bf16), ("gcn", 1, f32),
                      ("50k fwd", 32, bf16), ("50k bwd", 32, bf16),
                      ("50k fwd", 1, f32), ("50k fwd", 2, bf16),
                      ("node-sharded rank 0", 64, bf16),
                      ("node-sharded rank 0", 128, bf16),
                      ("halo rank 0", 64, bf16), ("halo rank 0", 128, bf16)]
        for name, f, dtype in k3_shapes:
            k3, rows = k3_layouts[name]
            x = feats(rows, f, dtype)
            mean, raw = turns({
                "other": lambda: k3_call(entries["other spmm_bucketed"], x,
                                         k3),
                "this": lambda: k3_call(entries["this spmm_bucketed"], x,
                                        k3)})
            emit(step="compare K3", layout=name, f=f, dtype=str(dtype),
                 this_over_other=mean["this"] / mean["other"], ms=mean,
                 turns=raw)
        # ... K1 ...
        for name, f in [("fb train", f) for f in (16, 24, 192, 512, 768)] + [
                ("50k", 16), ("50k", 24)]:
            nbr, w, nx = k1_layouts[name]
            x = feats(nx, f)
            mean, raw = turns({
                "other": lambda: k1_call(entries["other spmm_ell"], nbr, w,
                                         x),
                "this": lambda: k1_call(entries["this spmm_ell"], nbr, w, x)})
            emit(step="compare K1", layout=name, nbr=list(nbr.shape), f=f,
                 this_over_other=mean["this"] / mean["other"], ms=mean,
                 turns=raw)
        # ... and K2 at the GCN's shapes (a step's 16,384 pairs, the 51,200
        # test pairs, a rank's pairs over its gathered rows; F = 128 bf16)
        for name, (src, dst, n) in k2_pairs.items():
            table = feats(n, 128, bf16)
            mean, raw = turns({
                "other": lambda: k2_call(entries["other sddmm"], src, dst,
                                         table, table),
                "this": lambda: k2_call(entries["this sddmm"], src, dst,
                                        table, table)})
            emit(step="compare K2", pairs=name, e=int(src.shape[0]), f=128,
                 dtype="torch.bfloat16",
                 this_over_other=mean["this"] / mean["other"], ms=mean,
                 turns=raw)
    emit(step="done", estimated_readings=cs.ESTIMATED_READINGS[0])


if __name__ == "__main__":
    main()
