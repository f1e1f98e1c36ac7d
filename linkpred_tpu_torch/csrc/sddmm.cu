// K2 on Hopper: SDDMM, out[e] = sum_f x[src[e], f] * y[dst[e], f], and its
// gradient.
//
// Replaces the TPU kernel `sddmm_pallas` (linkpred_tpu/ops/pallas_kernels.py,
// body `_sddmm_kernel`). That kernel expands each block of 256 edge endpoints
// into two one-hot [256, N] matrices in VMEM, gathers the endpoint rows with
// two MXU products against the whole of x and y, and reduces their
// elementwise product: a form for the TPU's systolic array whose cost grows
// with N. Here the same function is a direct gather and reduction: an edge
// costs its two rows. The reference takes the gradient from XLA's autodiff
// of the gathers (linkpred_tpu/ops/sddmm.py), which XLA fuses into one
// scatter-add; here it is a kernel too (`sddmm_grad`).
//
// Forward operands: src, dst [E] int32; x [NX, F] and y [NY, F], both float32
// or both bfloat16, row-major and contiguous; out [E] float32 (written in
// full), as the TPU kernel returns f32. Products are summed in f32 in a fixed
// order (each lane over its features, then a butterfly across the edge's
// lanes), so a result does not change from run to run. An edge with an index
// outside its table scores 0, as a one-hot row of zeros gives in the TPU
// kernel.
//
// What bounds the forward on an H100: in the GCN slice's training step
// E = 16,384 edges (8,192 positive, 8,192 negative) over F = 128 bf16
// features, so a call reads 2 x 16,384 rows of 256 bytes (at most 8.4 MB,
// from a 60 MB table) and writes 64 KB: 0.0021 ms at 3.35 TB/s; at test time
// E = 51,200. The arithmetic (2 flops per element read) is negligible, and at
// this size the time is the chain of dependent reads an edge costs (its
// indices, then its rows) and how many edges the card has in flight.
//
// Forward design: rows of whole 16-byte groups on 16-byte boundaries take the
// packed kernel (`sddmm_packed_kernel`): G lanes an edge, G the row's groups
// rounded up to a power of two (16 at F = 128 bf16), so 32 / G edges are read
// at once, each lane one 16-byte `ld.global.nc.v4` of each row (two, both in
// flight, where a row holds more than 32 groups). A warp reads its edges'
// indices once, coalesced, and hands each edge's pair to its lanes by
// __shfl_sync; it takes kPackedRounds rounds of 32 / G edges with all their
// row reads in flight at once. A butterfly within an edge's lanes ends it. Any other shape takes the warp-per-edge
// kernel (`sddmm_kernel`): lanes across F, two features a lane where the rows
// allow it.
//
// Gradient: g [E] f32 (the cotangent of out) gives
//   dx[n] = sum_{e: src[e] = n} g[e] y[dst[e]],
//   dy[n] = sum_{e: dst[e] = n} g[e] x[src[e]],
// and, when x and y are one table, dh = dx + dy as one output. The 2E
// incidences (i < E: row src[i] receives g[i] y[dst[i]]; i = E + e: row
// dst[e] receives g[e] x[src[e]]) come sorted by receiving row in `order`
// [2E] int32 (a stable sort, built by the caller: `incidence_order` in
// ops/hopper_kernels.py); with two tables, positions [0, E) hold the src
// incidences sorted by src and [E, 2E) the dst ones sorted by dst. The
// sorted positions fall into windows of kGradWindow (16); a run of one
// receiving row may span many (one node named by ~400 of a GCN step's
// 32,768 incidences, measured on the collab graph's batches). Pass 1: a
// group of G lanes a window (G as in the forward) reads the window's
// incidences and all their rows at once and sums each piece of one row in
// sorted order, in f32; a run that lies in the window is written out once,
// rounded to the table's type, and a run that goes on past the window's
// edge leaves the sum of its piece in a scratch row. Pass 2: the group of
// the window where such a run begins adds the pieces' sums in window order,
// kGradAhead windows read at once, and writes the row. So a long run costs
// a few rounds of reads, not one round per few incidences, and every row
// is written once, in a fixed order, with no atomics: two launches agree
// bit for bit. The caller zeroes the outputs first (rows no pair names stay
// 0). A pair with an index outside its table contributes nothing, as it
// scored 0. What bounds it: writing dh (60.2 MB at the GCN's [235000, 128]
// bf16, most of it the zeros) and reading the named rows, the incidences and
// g: ~0.021 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_io.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;
// Rounds of 32 / G edges a warp of the packed kernel takes (one where G = 1:
// 32 edges a warp already). Device ms per call on an NVIDIA H100 80GB HBM3
// at 700 W, each forced and timed in turns by kernel_turns.py (rounds 1 / 2
// / 4, the warp-per-edge kernel after the slash): the GCN step's 16,384
// pairs over [235000, 128] bf16 0.00287 / 0.00272 / 0.00287, 0.00425; the
// 51,200 test pairs 0.00620 / 0.00535 / 0.00563, 0.00988; a rank's 16,384
// pairs over its gathered [32768, 128] bf16 0.00288 / 0.00279 / 0.00294,
// 0.00421; the step at F = 64 bf16 0.00218 / 0.00222 / 0.00239, 0.00399; at
// F = 128 f32 0.00445 / 0.00416 / 0.00462, 0.00454; at F = 32 bf16 0.00193
// / 0.00191 / 0.00221, 0.00400; the test pairs at F = 32 bf16 0.00266 /
// 0.00258 / 0.00270, 0.00924. Two rounds are the fastest at six of the
// seven and within 2 % at the seventh; counting the card's resident warps
// picked no better.
constexpr int kPackedRounds = 2;
// The gradient's sorted positions a group of pass 1 takes (all their row
// reads in flight at once), and the windows whose states and sums pass 2
// reads at once.
constexpr int kGradWindow = 16;
constexpr int kGradAhead = 8;

// Warp per edge: lanes across F, kVec features a lane (2 when F is even and
// the bases aligned, as float2 / __nv_bfloat162), then a shuffle reduction.
template <typename T, int kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sddmm_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const T* __restrict__ x, const T* __restrict__ y,
             float* __restrict__ out, int e, int nx, int ny, int f) {
  const int edge = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (edge >= e) return;  // warp-uniform: whole warps leave together
  const int s = src[edge];
  const int d = dst[edge];
  float acc = 0.0f;
  if (s >= 0 && s < nx && d >= 0 && d < ny) {  // warp-uniform
    const T* xr = x + static_cast<int64_t>(s) * f;
    const T* yr = y + static_cast<int64_t>(d) * f;
    for (int col = lane * kVec; col < f; col += kWarp * kVec) {
      if (kVec == 2) {
        const float2 a = FeatureIo<T>::load2(xr + col);
        const float2 b = FeatureIo<T>::load2(yr + col);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      } else {
        acc = fmaf(FeatureIo<T>::load(xr + col), FeatureIo<T>::load(yr + col),
                   acc);
      }
    }
  }
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc += __shfl_xor_sync(kFullMask, acc, offset);
  }
  if (lane == 0) out[edge] = acc;
}

// Packed edges: kGroup lanes an edge, 32 / kGroup edges a round, kRounds
// rounds a warp, kPasses 16-byte reads of each row a lane in one go (rows of
// more than kGroup * kPasses groups loop). Lane (r, c) = (lane / kGroup,
// lane % kGroup) sums, over its column groups c, c + kGroup, ... in order,
// the products of edge r of each round; the edge's lanes then meet in a
// butterfly (lanes kGroup / 2, ..., 1 apart) and lane c = 0 writes.
template <typename T, int kGroup, int kRounds, int kPasses>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sddmm_packed_kernel(const int32_t* __restrict__ src,
                    const int32_t* __restrict__ dst, const T* __restrict__ x,
                    const T* __restrict__ y, float* __restrict__ out, int e,
                    int nx, int ny, int f) {
  constexpr int kAtOnce = kWarp / kGroup;
  constexpr int kEdges = kAtOnce * kRounds;  // <= 32
  constexpr int kW = FeatureIo<T>::kWide;
  static_assert(kEdges <= kWarp, "a warp reads its edges' indices at once");
  const int64_t e0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp) *
      kEdges;
  const int lane = threadIdx.x % kWarp;
  if (e0 >= e) return;  // warp-uniform: whole warps leave together
  // the warp's edges' endpoints, one coalesced read of each array; a pair
  // with an index outside its table reads nothing and scores 0
  int s = 0, d = 0, ok = 0;
  if (lane < kEdges && e0 + lane < e) {
    s = src[e0 + lane];
    d = dst[e0 + lane];
    ok = s >= 0 && s < nx && d >= 0 && d < ny;
  }
  const int r = lane / kGroup;
  const int c = lane % kGroup;
  const T* xr[kRounds];
  const T* yr[kRounds];
  bool live[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int from = k * kAtOnce + r;
    const int sk = __shfl_sync(kFullMask, s, from);
    const int dk = __shfl_sync(kFullMask, d, from);
    live[k] = __shfl_sync(kFullMask, ok, from) != 0;
    xr[k] = x + (live[k] ? static_cast<int64_t>(sk) * f : 0);
    yr[k] = y + (live[k] ? static_cast<int64_t>(dk) * f : 0);
  }
  const int groups = f / kW;
  float acc[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) acc[k] = 0.0f;
  for (int g0 = c; g0 < groups; g0 += kGroup * kPasses) {
    uint4 a[kPasses][kRounds], b[kPasses][kRounds];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int g = g0 + p * kGroup;
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        a[p][k] = load16_if(xr[k] + g * kW, live[k] && g < groups);
        b[p][k] = load16_if(yr[k] + g * kW, live[k] && g < groups);
      }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        float va[kW], vb[kW];
        FeatureIo<T>::unpack(a[p][k], va);
        FeatureIo<T>::unpack(b[p][k], vb);
#pragma unroll
        for (int i = 0; i < kW; ++i) acc[k] = fmaf(va[i], vb[i], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) {
      acc[k] += __shfl_xor_sync(kFullMask, acc[k], off);
    }
    const int64_t edge = e0 + k * kAtOnce + r;
    if (c == 0 && edge < e) out[edge] = acc[k];
  }
}

template <typename T, int kGroup, int kRounds, int kPasses>
void launch_packed_rounds(const int32_t* src, const int32_t* dst, const T* x,
                          const T* y, float* out, int64_t e, int64_t nx,
                          int64_t ny, int64_t f, cudaStream_t stream) {
  constexpr int64_t kEdges = kWarp / kGroup * kRounds;
  const int64_t warps = (e + kEdges - 1) / kEdges;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sddmm_packed_kernel<T, kGroup, kRounds, kPasses>
      <<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0, stream>>>(
          src, dst, x, y, out, static_cast<int>(e), static_cast<int>(nx),
          static_cast<int>(ny), static_cast<int>(f));
}

template <typename T, int kGroup>
void launch_packed_group(const int32_t* src, const int32_t* dst, const T* x,
                         const T* y, float* out, int64_t e, int64_t nx,
                         int64_t ny, int64_t f, cudaStream_t stream) {
  constexpr int kRounds = kGroup > 1 ? kPackedRounds : 1;
  launch_packed_rounds<T, kGroup, kRounds, 1>(src, dst, x, y, out, e, nx, ny,
                                             f, stream);
}

template <typename T>
int launch(const int32_t* src, const int32_t* dst, const void* x,
           const void* y, float* out, int64_t e, int64_t nx, int64_t ny,
           int64_t f, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  // Dispatch by shape: rows of whole 16-byte groups on 16-byte boundaries
  // take the packed kernel, G lanes an edge; every other shape the
  // warp-per-edge kernel.
  if (wide_aligned(f, sizeof(T), 16, {x, y})) {
    const int64_t groups = f * static_cast<int64_t>(sizeof(T)) / 16;
    if (groups <= 1) {
      launch_packed_group<T, 1>(src, dst, xt, yt, out, e, nx, ny, f, stream);
    } else if (groups <= 2) {
      launch_packed_group<T, 2>(src, dst, xt, yt, out, e, nx, ny, f, stream);
    } else if (groups <= 4) {
      launch_packed_group<T, 4>(src, dst, xt, yt, out, e, nx, ny, f, stream);
    } else if (groups <= 8) {
      launch_packed_group<T, 8>(src, dst, xt, yt, out, e, nx, ny, f, stream);
    } else if (groups <= 16) {
      launch_packed_group<T, 16>(src, dst, xt, yt, out, e, nx, ny, f, stream);
    } else if (groups <= 32) {
      launch_packed_group<T, 32>(src, dst, xt, yt, out, e, nx, ny, f, stream);
    } else {
      launch_packed_rounds<T, 32, 1, 2>(src, dst, xt, yt, out, e, nx, ny, f,
                                        stream);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks =
      static_cast<unsigned>((e + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (pairs_aligned(f, sizeof(T), {x, y})) {
    sddmm_kernel<T, 2><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        src, dst, xt, yt, out, static_cast<int>(e), static_cast<int>(nx),
        static_cast<int>(ny), static_cast<int>(f));
  } else {
    sddmm_kernel<T, 1><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        src, dst, xt, yt, out, static_cast<int>(e), static_cast<int>(nx),
        static_cast<int>(ny), static_cast<int>(f));
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the gradient
// ---------------------------------------------------------------------------

// Incidence `i` of the pairs: the row that receives it, the row it reads,
// its pair, whether it reads x (a dst incidence) or y, and whether both of
// the pair's indices lie inside their tables.
struct Incidence {
  int row, partner, pair;
  bool from_dst, ok;
};

__device__ __forceinline__ Incidence incidence(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int i,
    int e, int nx, int ny) {
  const bool from_dst = i >= e;
  const int pair = from_dst ? i - e : i;
  const int s = src[pair];
  const int d = dst[pair];
  return {from_dst ? d : s, from_dst ? s : d, pair, from_dst,
          s >= 0 && s < nx && d >= 0 && d < ny};
}

// What pass 1 leaves for pass 2 about a window, in `state`.
constexpr int kHeadCont = 1;  // its first piece goes on with an earlier
                              // window's run; the piece's sum in part[w][0]
constexpr int kTailCont = 2;  // its last piece's run goes on into the next
                              // window (begun here: the sum in part[w][1])
constexpr int kWhole = 4;     // one piece covers the window: with kHeadCont,
                              // its sum is in part[w][0]
constexpr int kSecond = 8;    // that run is in the second half (dy)

// Rounds a lane's kW f32 sums into the row `out` (columns c0 * kW on).
template <typename T, bool kWideRows>
__device__ __forceinline__ void store_row(T* out, int c0,
                                          const float (&acc)[kWideRows
                                              ? FeatureIo<T>::kWide : 1]) {
  if constexpr (kWideRows) {
    *reinterpret_cast<uint4*>(out + c0 * FeatureIo<T>::kWide) =
        FeatureIo<T>::pack(acc);
  } else {
    FeatureIo<T>::store(out + c0, acc[0]);
  }
}

// Pass 1: a group of kGroup lanes a window of kGradWindow sorted positions.
// It reads the window's incidences (every lane the same addresses: one
// transaction a warp, no shuffles, so the groups of a warp run apart), then
// all their rows at once, each lane its columns (kW features a column group
// when kWideRows, else one feature), and walks them in sorted order,
// summing each piece of one receiving row in f32. A piece whose run lies in
// the window is written out, rounded; the first piece, where it goes on
// with a run of an earlier window, and the last, where its run goes on into
// the next window, leave their sums in `part` for pass 2.
template <typename T, int kGroup, bool kWideRows>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sddmm_grad_kernel(const int32_t* __restrict__ order,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const float* __restrict__ g, const T* __restrict__ x,
                  const T* __restrict__ y, T* __restrict__ dx,
                  T* __restrict__ dy, float* __restrict__ part,
                  int* __restrict__ state, int* __restrict__ run_row, int e,
                  int nx, int ny, int f, int two_tables) {
  constexpr int kW = kWideRows ? FeatureIo<T>::kWide : 1;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kGroup;
  const int c = threadIdx.x % kGroup;
  const int64_t n2 = 2 * static_cast<int64_t>(e);
  const int64_t p0 = w * kGradWindow;
  if (p0 >= n2) return;  // group-uniform
  // positions from `mid` on are dy's (two tables); a run never crosses it
  const int64_t mid = two_tables ? e : n2;
  const int cnt = n2 - p0 < kGradWindow ? static_cast<int>(n2 - p0)
                                         : kGradWindow;
  Incidence in[kGradWindow];
#pragma unroll
  for (int u = 0; u < kGradWindow; ++u) {
    in[u] = u < cnt ? incidence(src, dst, order[p0 + u], e, nx, ny)
                    : Incidence{0, 0, 0, false, false};
  }
  // does the window's first run begin earlier, its last go on after it?
  const bool head_cont =
      p0 > 0 && p0 != mid &&
      incidence(src, dst, order[p0 - 1], e, nx, ny).row == in[0].row;
  const int64_t after = p0 + cnt;
  bool tail_cont = after < n2 && after != mid;
  if (tail_cont) {
    const int next = incidence(src, dst, order[after], e, nx, ny).row;
    int last = in[0].row;
#pragma unroll
    for (int u = 1; u < kGradWindow; ++u) last = u < cnt ? in[u].row : last;
    tail_cont = next == last;
  }
  float gu[kGradWindow];
#pragma unroll
  for (int u = 0; u < kGradWindow; ++u) {
    gu[u] = u < cnt && in[u].ok ? g[in[u].pair] : 0.0f;
  }
  const int cols = f / kW;
  int st = 0;
  for (int c0 = c; c0 < cols; c0 += kGroup) {
    // every row of the window in flight at once
    uint4 raw[kGradWindow];
    float one[kGradWindow];
#pragma unroll
    for (int u = 0; u < kGradWindow; ++u) {
      const bool read = u < cnt && in[u].ok;
      // the partner's table: y for a src incidence, x for a dst one
      const T* row = (in[u].from_dst ? x : y) +
                     (read ? static_cast<int64_t>(in[u].partner) * f : 0);
      if constexpr (kWideRows) {
        raw[u] = load16_if(row + c0 * kW, read);
      } else {
        one[u] = load_feature_if(row + c0, read);
      }
    }
    // the walk: the piece open now began at the window's start (`first`)
    // or later, and receives row `piece` of the half `second`
    float acc[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = 0.0f;
    int piece = in[0].row;
    bool first = true, second = p0 >= mid;
    st = 0;
#pragma unroll
    for (int u = 0; u < kGradWindow; ++u) {
      if (u < cnt) {
        const bool half = p0 + u >= mid;
        if (u > 0 && (in[u].row != piece || half != second)) {
          // the open piece ends before the window does
          if (first && head_cont) {
            float* pp = part + (2 * w) * f + c0 * kW;
#pragma unroll
            for (int i = 0; i < kW; ++i) pp[i] = acc[i];
            st |= kHeadCont;
          } else if (piece >= 0 && piece < (second ? ny : nx)) {
            store_row<T, kWideRows>(
                (second ? dy : dx) + static_cast<int64_t>(piece) * f, c0,
                acc);
          }
          piece = in[u].row;
          first = false;
          second = half;
#pragma unroll
          for (int i = 0; i < kW; ++i) acc[i] = 0.0f;
        }
        if constexpr (kWideRows) {
          float v[kW];
          FeatureIo<T>::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < kW; ++i) acc[i] = fmaf(gu[u], v[i], acc[i]);
        } else {
          acc[0] = fmaf(gu[u], one[u], acc[0]);
        }
      }
    }
    // the window's last piece
    if (first && head_cont) {
      float* pp = part + (2 * w) * f + c0 * kW;
#pragma unroll
      for (int i = 0; i < kW; ++i) pp[i] = acc[i];
      st |= kHeadCont | kWhole | (tail_cont ? kTailCont : 0);
    } else if (tail_cont) {
      float* pp = part + (2 * w + 1) * f + c0 * kW;
#pragma unroll
      for (int i = 0; i < kW; ++i) pp[i] = acc[i];
      st |= kTailCont;
      if (c == 0) run_row[w] = piece;
    } else if (piece >= 0 && piece < (second ? ny : nx)) {
      store_row<T, kWideRows>(
          (second ? dy : dx) + static_cast<int64_t>(piece) * f, c0, acc);
    }
    if (tail_cont && second) st |= kSecond;
  }
  if (c == 0) state[w] = st;
}

// Pass 2: a group of kGroup lanes a window. The group of a window where a
// run begins that goes on into later windows adds, in window order, that
// run's sum in the window (part[w][1]) and the first-piece sums of the
// windows it covers (part[v][0]), kGradAhead windows' states and sums read
// at once, and writes the row, rounded.
template <typename T, int kGroup, bool kWideRows>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sddmm_grad_merge_kernel(const float* __restrict__ part,
                        const int* __restrict__ state,
                        const int* __restrict__ run_row, T* __restrict__ dx,
                        T* __restrict__ dy, int64_t windows, int nx, int ny,
                        int f) {
  constexpr int kW = kWideRows ? FeatureIo<T>::kWide : 1;
  constexpr int kMiddle = kHeadCont | kWhole | kTailCont;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kGroup;
  const int c = threadIdx.x % kGroup;
  if (w >= windows) return;  // group-uniform
  const int st = state[w];
  if ((st & (kTailCont | kWhole)) != kTailCont) return;
  const bool second = (st & kSecond) != 0;
  const int r = run_row[w];
  if (r < 0 || r >= (second ? ny : nx)) return;
  T* orow = (second ? dy : dx) + static_cast<int64_t>(r) * f;
  const int cols = f / kW;
  for (int c0 = c; c0 < cols; c0 += kGroup) {
    float acc[kW];
    const float* own = part + (2 * w + 1) * f + c0 * kW;
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = own[i];
    bool going = true;
    for (int64_t v0 = w + 1; going; v0 += kGradAhead) {
      int sv[kGradAhead];
      float pv[kGradAhead][kW];
#pragma unroll
      for (int a = 0; a < kGradAhead; ++a) {
        const bool in = v0 + a < windows;
        sv[a] = in ? state[v0 + a] : 0;
        const float* pp = part + (2 * (in ? v0 + a : w)) * f + c0 * kW;
#pragma unroll
        for (int i = 0; i < kW; ++i) pv[a][i] = pp[i];
      }
#pragma unroll
      for (int a = 0; a < kGradAhead; ++a) {
        if (going) {
#pragma unroll
          for (int i = 0; i < kW; ++i) acc[i] += pv[a][i];
          going = (sv[a] & kMiddle) == kMiddle;
        }
      }
    }
    store_row<T, kWideRows>(orow, c0, acc);
  }
}

template <typename T, int kGroup, bool kWideRows>
void launch_grad_group(const int32_t* order, const int32_t* src,
                       const int32_t* dst, const float* g, const T* x,
                       const T* y, T* dx, T* dy, float* part, int* state,
                       int* run_row, int64_t e, int64_t nx, int64_t ny,
                       int64_t f, int two_tables, cudaStream_t stream) {
  const int64_t windows = (2 * e + kGradWindow - 1) / kGradWindow;
  const int64_t blocks = (windows * kGroup + kWarp * kWarpsPerBlock - 1) /
                         (kWarp * kWarpsPerBlock);
  sddmm_grad_kernel<T, kGroup, kWideRows>
      <<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0, stream>>>(
          order, src, dst, g, x, y, dx, dy, part, state, run_row,
          static_cast<int>(e), static_cast<int>(nx), static_cast<int>(ny),
          static_cast<int>(f), two_tables);
  sddmm_grad_merge_kernel<T, kGroup, kWideRows>
      <<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0, stream>>>(
          part, state, run_row, dx, dy, windows, static_cast<int>(nx),
          static_cast<int>(ny), static_cast<int>(f));
}

template <typename T>
int launch_grad(const int32_t* order, const int32_t* src, const int32_t* dst,
                const float* g, const void* x, const void* y, void* dx,
                void* dy, float* part, int* state, int* run_row, int64_t e,
                int64_t nx, int64_t ny, int64_t f, int two_tables,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  T* dyt = static_cast<T*>(dy);
  // Rows of whole 16-byte groups on 16-byte boundaries: G lanes a window,
  // G the row's groups rounded up to a power of two (up to 32, then the lanes
  // loop over the groups); every other shape: 32 lanes a window, a feature a
  // lane.
  if (wide_aligned(f, sizeof(T), 16, {x, y, dx, dy})) {
    const int64_t groups = f * static_cast<int64_t>(sizeof(T)) / 16;
#define GRAD(G)                                                             \
  launch_grad_group<T, G, true>(order, src, dst, g, xt, yt, dxt, dyt, part, \
                                state, run_row, e, nx, ny, f, two_tables,   \
                                stream)
    if (groups <= 1) {
      GRAD(1);
    } else if (groups <= 2) {
      GRAD(2);
    } else if (groups <= 4) {
      GRAD(4);
    } else if (groups <= 8) {
      GRAD(8);
    } else if (groups <= 16) {
      GRAD(16);
    } else {
      GRAD(32);
    }
#undef GRAD
  } else {
    launch_grad_group<T, kWarp, false>(order, src, dst, g, xt, yt, dxt, dyt,
                                       part, state, run_row, e, nx, ny, f,
                                       two_tables, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t, PyTorch's current stream).
// dtype: 0 float32, 1 bfloat16 (x and y). Returns cudaGetLastError() after
// the launch: 0 when it was accepted. Does not synchronise and allocates
// nothing; the caller owns every buffer.
int sddmm(int dtype, const int32_t* src, const int32_t* dst, const void* x,
          const void* y, float* out, int64_t e, int64_t nx, int64_t ny,
          int64_t f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(src, dst, x, y, out, e, nx, ny, f, s);
    case 1:
      return launch<__nv_bfloat16>(src, dst, x, y, out, e, nx, ny, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K2's gradient on `stream` (pass 1, then pass 2): the rows the
// pairs name, of dx [NX, F] and (two_tables) dy [NY, F], or of one dh [NX,
// F] in dx when x and y are one table (y == x, dy unused). `g` [E] f32,
// `order` [2E] int32 as above. The caller zeroes dx and dy first and gives
// the passes' scratch for W = ceil(2E / 16) windows: part [W, 2, F] f32,
// state [W] and run_row [W] int32 (written before they are read: no need
// to clear them). dtype as for `sddmm`; returns cudaGetLastError().
int sddmm_grad(int dtype, const int32_t* order, const int32_t* src,
               const int32_t* dst, const float* g, const void* x,
               const void* y, void* dx, void* dy, float* part, int* state,
               int* run_row, int64_t e, int64_t nx, int64_t ny, int64_t f,
               int two_tables, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (2 * e >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_grad<float>(order, src, dst, g, x, y, dx, dy, part,
                                state, run_row, e, nx, ny, f, two_tables, s);
    case 1:
      return launch_grad<__nv_bfloat16>(order, src, dst, g, x, y, dx, dy,
                                        part, state, run_row, e, nx, ny, f,
                                        two_tables, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sddmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
