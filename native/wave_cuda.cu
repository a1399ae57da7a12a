// Wavefront (anti-diagonal) banded affine-gap DP and its traceback walk
// for NVIDIA Hopper, called from JAX through the XLA FFI.
//
// The recurrence and the wire format are those of
// telr_jax/kernels/wave_align.py, whose XLA form is the bit-exact
// reference for both kernels here.
//
// telr_wave_dp: one pair per warp group.  Each thread owns C = 4
// consecutive band cells and keeps H, H(-1), I, D and the q/t windows in
// registers for the whole step loop, which runs inside one launch.  Every
// predecessor access is a +-1 cell shift: inside a thread it is a register
// move, across threads of a warp a shuffle, across warps a shared-memory
// halo (double-buffered, one __syncthreads per step).  Per-step metadata is
// staged through shared memory in tiles; direction bytes leave as one
// coalesced 32-bit store per thread and step, in (pair, step, cell) order
// so that a pair's walk reads one contiguous region.  Band width and step
// count are runtime values: one build serves every shape.  At W = 128 a
// pair is one warp and a block holds four pairs.
//
// telr_wave_walk: one thread per pair follows its own direction bytes from
// the start cell back to the alignment start, emitting the same packed op
// codes (four 2-bit codes per byte, column t = S_pad - s) as the XLA sweep.
//
// Build: make -C native cuda (nvcc -gencode arch=compute_90a,code=sm_90a).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kNeg = -(1 << 30);
constexpr int kCells = 4;        // band cells per thread
constexpr int kMetaTile = 256;   // steps staged in shared memory at once
constexpr int kGlobal = 0, kLocal = 2;

struct Scores {
  int32_t ma, mi, go, ge, amb;
};

__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) {
  return a > b ? a : b;
}

// (value, lane, step) argmax: larger value wins, ties go to the lower lane
__device__ __forceinline__ void take_better(int32_t& v, int32_t& p,
                                            int32_t& s, int32_t ov,
                                            int32_t op, int32_t os) {
  if (ov > v || (ov == v && op < p)) {
    v = ov;
    p = op;
    s = os;
  }
}

__global__ void wave_dp_kernel(const int8_t* __restrict__ meta,
                               const int8_t* __restrict__ qw0,
                               const int8_t* __restrict__ tw0,
                               const int32_t* __restrict__ scal,
                               int8_t* __restrict__ dirs,
                               int32_t* __restrict__ res, int64_t n_pairs,
                               int64_t s_pad, int32_t W, int32_t mode,
                               Scores sc) {
  const int T = blockDim.x;  // threads per pair = W / kCells
  const int nw = T >> 5;     // warps per pair
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t pair = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const bool multi = nw > 1;  // one pair per block when true

  extern __shared__ int32_t smem[];
  // [blockDim.y][kMetaTile] int8 tiles, then (multi only) the halo
  // [2][nw][4] and the reduction scratch [nw][4]
  int8_t* tile = reinterpret_cast<int8_t*>(smem) + threadIdx.y * kMetaTile;
  int32_t* halo = smem + (blockDim.y * kMetaTile) / 4;
  int32_t* red = halo + 2 * nw * 4;

  if (pair >= n_pairs) return;  // whole warp (or block when multi)

  auto sync = [&]() {
    if (multi) __syncthreads(); else __syncwarp();
  };

  const int32_t lq = scal[pair * 4 + 0], lt = scal[pair * 4 + 1];
  int32_t i0v = scal[pair * 4 + 2], j0v = scal[pair * 4 + 3];
  const int64_t n_steps = (int64_t)lq + lt;
  const int p0 = tid * kCells;
  const int32_t gap_open = sc.go + sc.ge;

  int32_t H1[kCells], H2[kCells], I1[kCells], D1[kCells];
  int32_t QW[kCells], TW[kCells], hb[kCells], sb[kCells], gb[kCells];
#pragma unroll
  for (int c = 0; c < kCells; c++) {
    const int p = p0 + c;
    H1[c] = (i0v - p == 0 && j0v + p == 0) ? 0 : kNeg;
    H2[c] = I1[c] = D1[c] = kNeg;
    QW[c] = qw0[pair * W + p];
    TW[c] = tw0[pair * W + p];
    hb[c] = 0;
    sb[c] = 0;
    gb[c] = kNeg;
  }
  int dprev = 0;
  const int8_t* mrow = meta + pair * s_pad;
  int8_t* drow = dirs + pair * s_pad * W;

  for (int64_t base = 0; base < n_steps; base += kMetaTile) {
    sync();  // the previous tile is consumed
    for (int k = tid; k < kMetaTile; k += T) {
      if (base + k < s_pad) tile[k] = mrow[base + k];
    }
    sync();
    const int lim =
        (int)(n_steps - base < kMetaTile ? n_steps - base : kMetaTile);
    for (int k = 0; k < lim; k++) {
      const int64_t s = base + k + 1;
      const int mc = tile[k];
      const bool dbit = mc & 1;
      const int d = dbit ? 1 : -1;
      const int q_in = (mc >> 1) & 7, t_in = (mc >> 4) & 7;
      const int dd = d + dprev;
      i0v += dbit ? 0 : 1;
      j0v += dbit ? 1 : 0;

      // the four values this thread's neighbour needs: drift +1 shifts
      // toward lower cells (send cell 0 down), drift -1 toward higher
      // cells (send cell C-1 up)
      int32_t snd0 = dbit ? H1[0] : H1[kCells - 1];
      int32_t snd1 = dbit ? I1[0] : D1[kCells - 1];
      int32_t snd2 = dbit ? TW[0] : QW[kCells - 1];
      int32_t snd3 = dbit ? H2[0] : H2[kCells - 1];
      int32_t nb0, nb1, nb2, nb3;
      if (dbit) {
        nb0 = __shfl_down_sync(0xffffffffu, snd0, 1);
        nb1 = __shfl_down_sync(0xffffffffu, snd1, 1);
        nb2 = __shfl_down_sync(0xffffffffu, snd2, 1);
        nb3 = __shfl_down_sync(0xffffffffu, snd3, 1);
      } else {
        nb0 = __shfl_up_sync(0xffffffffu, snd0, 1);
        nb1 = __shfl_up_sync(0xffffffffu, snd1, 1);
        nb2 = __shfl_up_sync(0xffffffffu, snd2, 1);
        nb3 = __shfl_up_sync(0xffffffffu, snd3, 1);
      }
      if (multi) {
        int32_t* hb_buf = halo + (s & 1) * nw * 4;
        if ((dbit && lane == 0) || (!dbit && lane == 31)) {
          hb_buf[warp * 4 + 0] = snd0;
          hb_buf[warp * 4 + 1] = snd1;
          hb_buf[warp * 4 + 2] = snd2;
          hb_buf[warp * 4 + 3] = snd3;
        }
        __syncthreads();
        if (dbit && lane == 31 && warp + 1 < nw) {
          nb0 = hb_buf[(warp + 1) * 4 + 0];
          nb1 = hb_buf[(warp + 1) * 4 + 1];
          nb2 = hb_buf[(warp + 1) * 4 + 2];
          nb3 = hb_buf[(warp + 1) * 4 + 3];
        } else if (!dbit && lane == 0 && warp > 0) {
          nb0 = hb_buf[(warp - 1) * 4 + 0];
          nb1 = hb_buf[(warp - 1) * 4 + 1];
          nb2 = hb_buf[(warp - 1) * 4 + 2];
          nb3 = hb_buf[(warp - 1) * 4 + 3];
        }
      }
      // band edges: nothing beyond cell W-1 or before cell 0
      if (dbit && tid == T - 1) {
        nb0 = nb1 = nb3 = kNeg;
        nb2 = t_in;
      } else if (!dbit && tid == 0) {
        nb0 = nb1 = nb3 = kNeg;
        nb2 = q_in;
      }

      int32_t Hv[kCells], Iv[kCells], Hh[kCells], Dh[kCells], Hd[kCells];
#pragma unroll
      for (int c = 0; c < kCells; c++) {
        const int32_t h1n = c + 1 < kCells ? H1[c + 1] : nb0;  // cell p+1
        const int32_t h1p = c > 0 ? H1[c - 1] : nb0;            // cell p-1
        Hv[c] = dbit ? h1n : H1[c];
        Iv[c] = dbit ? (c + 1 < kCells ? I1[c + 1] : nb1) : I1[c];
        Hh[c] = dbit ? H1[c] : h1p;
        Dh[c] = dbit ? D1[c] : (c > 0 ? D1[c - 1] : nb1);
        if (dd == 2) {
          Hd[c] = c + 1 < kCells ? H2[c + 1] : nb3;
        } else if (dd == -2) {
          Hd[c] = c > 0 ? H2[c - 1] : nb3;
        } else {
          Hd[c] = H2[c];
        }
      }
      if (dbit) {
#pragma unroll
        for (int c = 0; c < kCells; c++) {
          TW[c] = c + 1 < kCells ? TW[c + 1] : nb2;
        }
      } else {
#pragma unroll
        for (int c = kCells - 1; c >= 0; c--) {
          QW[c] = c > 0 ? QW[c - 1] : nb2;
        }
      }

      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < kCells; c++) {
        const int p = p0 + c;
        int32_t I = imax(Hv[c] - gap_open, Iv[c] - sc.ge);
        int32_t D = imax(Hh[c] - gap_open, Dh[c] - sc.ge);
        const int32_t s_ij = (QW[c] == 4 || TW[c] >= 4)
                                 ? sc.amb
                                 : (QW[c] == TW[c] ? sc.ma : -sc.mi);
        const int32_t Hdg = Hd[c] + s_ij;
        int32_t H = imax(Hdg, imax(I, D));
        if (mode == kLocal) H = imax(H, 0);
        const int32_t iv = i0v - p, jv = j0v + p;
        if (iv == 0 && jv == 0) {
          H = 0;
        } else if (iv == 0) {
          H = mode == kLocal ? 0 : -(sc.go + sc.ge * jv);
        } else if (jv == 0) {
          H = mode == kLocal ? 0 : -(sc.go + sc.ge * iv);
        }
        const bool valid = iv >= 0 && iv <= lq && jv >= 0 && jv <= lt;
        if (!valid) {
          H = kNeg;
          I = kNeg;
          D = kNeg;
        }
        const bool inner = valid && iv >= 1 && jv >= 1;
        if (inner && iv == lq && jv == lt) gb[c] = imax(gb[c], H);
        if (mode != kGlobal && inner && H > hb[c]) {
          hb[c] = H;
          sb[c] = (int32_t)s;
        }
        int choice = H == Hdg ? 0 : (H == D ? 1 : 2);
        if (mode == kLocal && H == 0) choice = 3;
        if (iv <= 0 || jv <= 0) choice = 3;
        const int dext = (D != Hh[c] - gap_open) && (D > kNeg / 2);
        const int iext = (I != Hv[c] - gap_open) && (I > kNeg / 2);
        word |= (uint32_t)(choice | (dext << 2) | (iext << 3)) << (8 * c);
        H2[c] = H1[c];
        H1[c] = H;
        I1[c] = I;
        D1[c] = D;
      }
      *reinterpret_cast<uint32_t*>(drow + (s - 1) * W + p0) = word;
      dprev = d;
    }
  }

  // reductions: max end-cell score; best cell (lowest lane on ties) and
  // the step at which that lane first reached it
  int32_t g = gb[0], bv = hb[0], bp = p0, bs = sb[0];
#pragma unroll
  for (int c = 1; c < kCells; c++) {
    g = imax(g, gb[c]);
    take_better(bv, bp, bs, hb[c], p0 + c, sb[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    g = imax(g, __shfl_down_sync(0xffffffffu, g, off));
    const int32_t ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int32_t op = __shfl_down_sync(0xffffffffu, bp, off);
    const int32_t os = __shfl_down_sync(0xffffffffu, bs, off);
    take_better(bv, bp, bs, ov, op, os);
  }
  if (multi) {
    if (lane == 0) {
      red[warp * 4 + 0] = g;
      red[warp * 4 + 1] = bv;
      red[warp * 4 + 2] = bp;
      red[warp * 4 + 3] = bs;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nw; w++) {
        g = imax(g, red[w * 4 + 0]);
        take_better(bv, bp, bs, red[w * 4 + 1], red[w * 4 + 2],
                    red[w * 4 + 3]);
      }
    }
  }
  if (tid == 0) {
    int32_t* r = res + pair * 4;
    r[0] = g;
    if (mode == kGlobal) {
      r[1] = g;
      r[2] = 0;
      r[3] = 0;
    } else {
      r[1] = bv;
      r[2] = bs;
      r[3] = bp;
    }
  }
}

__device__ __forceinline__ int64_t floordiv2(int64_t x) {
  return x >= 0 ? x / 2 : -((-x + 1) / 2);
}

__global__ void wave_walk_kernel(const int8_t* __restrict__ dirs,
                                 const int8_t* __restrict__ meta,
                                 const int32_t* __restrict__ scal,
                                 const int32_t* __restrict__ res,
                                 uint8_t* __restrict__ packed,
                                 int32_t* __restrict__ small,
                                 int64_t n_pairs, int64_t s_pad, int32_t W,
                                 int32_t mode) {
  const int64_t pair = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= n_pairs) return;
  const int32_t lq = scal[pair * 4 + 0], lt = scal[pair * 4 + 1];
  const int64_t m0 = (int64_t)scal[pair * 4 + 3] - scal[pair * 4 + 2];
  const int32_t* r = res + pair * 4;
  const int8_t* mrow = meta + pair * s_pad;
  const int8_t* drow = dirs + pair * s_pad * W;

  // the start cell and the band base m at its step s0 = si + sj
  int64_t si, sj, s0;
  if (mode == kGlobal) {
    si = lq;
    sj = lt;
    s0 = si + sj;
  } else {
    s0 = r[2];
    si = sj = 0;
  }
  int64_t m = m0;
  for (int64_t k = 0; k < s0; k++) m += (mrow[k] & 1) ? 1 : -1;
  if (mode != kGlobal && s0 > 0) {
    const int64_t o = m + 2 * (int64_t)r[3];
    si = floordiv2(s0 - o);
    sj = floordiv2(s0 + o);
  }

  int64_t i = si, j = sj, s_m = s0;
  int st = 0;  // 0 = H, 1 = D, 2 = I
  int bad = 0;
  bool stopped = false;
  uint8_t* prow = packed + pair * (s_pad / 4);
  int64_t cur_idx = -1;
  uint32_t cur = 0xFF;
  while (i > 0 && j > 0 && !stopped) {
    const int64_t s = i + j;
    while (s_m > s) {  // m at step s_m - 1 = m at s_m minus its drift
      s_m--;
      m -= (mrow[s_m] & 1) ? 1 : -1;
    }
    const int64_t off = j - i - m;
    const int64_t p_raw = floordiv2(off);
    if ((off & 1) || p_raw < 0 || p_raw >= W) bad = 1;
    const int64_t p = p_raw < 0 ? 0 : (p_raw >= W ? W - 1 : p_raw);
    const int byte = drow[(s - 1) * W + p];
    const int ch = byte & 3;
    const bool in_h = st == 0;
    const bool stop_now = in_h && ch == 3;
    if (mode != kLocal && stop_now) bad = 1;
    const bool do_m = in_h && ch == 0;
    const bool do_d = ((in_h && ch == 1) || st == 1) && !stop_now && !do_m;
    const bool do_i =
        ((in_h && ch == 2) || st == 2) && !stop_now && !do_m && !do_d;
    const uint32_t op = do_m ? 0 : (do_d ? 1 : (do_i ? 2 : 3));
    const int64_t t = s_pad - s;
    if ((t >> 2) != cur_idx) {
      if (cur_idx >= 0) prow[cur_idx] = (uint8_t)cur;
      cur_idx = t >> 2;
      cur = 0xFF;
    }
    const int sh = (int)(t & 3) * 2;
    cur = (cur & ~(3u << sh)) | (op << sh);
    if (do_m || do_i) i--;
    if (do_m || do_d) j--;
    if (do_m) {
      st = 0;
    } else if (do_d) {
      st = (byte & 4) ? 1 : 0;
    } else if (do_i) {
      st = (byte & 8) ? 2 : 0;
    }
    if (stop_now) stopped = true;
  }
  if (cur_idx >= 0) prow[cur_idx] = (uint8_t)cur;
  small[0 * n_pairs + pair] = r[0];
  small[1 * n_pairs + pair] = r[1];
  small[2 * n_pairs + pair] = (int32_t)i;
  small[3 * n_pairs + pair] = (int32_t)j;
  small[4 * n_pairs + pair] = bad;
  small[5 * n_pairs + pair] = (int32_t)si;
  small[6 * n_pairs + pair] = (int32_t)sj;
}

ffi::Error launch_status(const char* what) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error WaveDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> meta,
                      ffi::Buffer<ffi::S8> qw, ffi::Buffer<ffi::S8> tw,
                      ffi::Buffer<ffi::S32> scal,
                      ffi::ResultBuffer<ffi::S8> dirs,
                      ffi::ResultBuffer<ffi::S32> res, int32_t mode,
                      int32_t ma, int32_t mi, int32_t go, int32_t ge,
                      int32_t amb) {
  const auto md = meta.dimensions();
  const auto wd = qw.dimensions();
  if (md.size() != 2 || wd.size() != 2 || wd[0] != md[0]) {
    return ffi::Error::InvalidArgument("telr_wave_dp: bad operand shapes");
  }
  const int64_t n = md[0], s_pad = md[1], W = wd[1];
  if (W % 128 != 0 || W > 4096) {
    return ffi::Error::InvalidArgument(
        "telr_wave_dp: band width must be a multiple of 128, at most 4096");
  }
  if (n == 0) return ffi::Error::Success();
  const int T = (int)(W / kCells);
  const int nw = T / 32;
  const int ppb = nw == 1 ? 4 : 1;  // pairs per block
  dim3 block(T, ppb);
  dim3 grid((unsigned)((n + ppb - 1) / ppb));
  size_t smem = ppb * kMetaTile + (nw > 1 ? (size_t)3 * nw * 4 * 4 : 0);
  Scores sc{ma, mi, go, ge, amb};
  wave_dp_kernel<<<grid, block, smem, stream>>>(
      meta.typed_data(), qw.typed_data(), tw.typed_data(),
      scal.typed_data(), dirs->typed_data(), res->typed_data(), n, s_pad,
      (int32_t)W, mode, sc);
  return launch_status("telr_wave_dp");
}

ffi::Error WaveWalkImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> dirs,
                        ffi::Buffer<ffi::S8> meta, ffi::Buffer<ffi::S32> scal,
                        ffi::Buffer<ffi::S32> res,
                        ffi::ResultBuffer<ffi::U8> packed,
                        ffi::ResultBuffer<ffi::S32> small, int32_t mode) {
  const auto dd = dirs.dimensions();
  if (dd.size() != 3) {
    return ffi::Error::InvalidArgument("telr_wave_walk: dirs must be 3-D");
  }
  const int64_t n = dd[0], s_pad = dd[1], W = dd[2];
  if (n == 0) return ffi::Error::Success();
  cudaMemsetAsync(packed->typed_data(), 0xFF, (size_t)n * (s_pad / 4),
                  stream);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  wave_walk_kernel<<<blocks, threads, 0, stream>>>(
      dirs.typed_data(), meta.typed_data(), scal.typed_data(),
      res.typed_data(), packed->typed_data(), small->typed_data(), n, s_pad,
      (int32_t)W, mode);
  return launch_status("telr_wave_walk");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TelrWaveDp, WaveDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("mode")
                                  .Attr<int32_t>("ma")
                                  .Attr<int32_t>("mi")
                                  .Attr<int32_t>("go")
                                  .Attr<int32_t>("ge")
                                  .Attr<int32_t>("amb"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(TelrWaveWalk, WaveWalkImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("mode"));
