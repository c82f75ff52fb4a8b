// Kernel K3: one pass of the long Fr NTT (csrc/ntt_pass.cuh has the
// design note and the block's body).
//
// A batch runs the same pass on `batch` transforms at once: row
// blockIdx.y of a contiguous [batch, 2^log_n, 8] buffer (the h pipeline's
// three vectors, and rows longer than K3b takes). The trips are radix 8
// where the launch's radix-8 butterflies fill every SM, else radix 4
// (ops/cuda/ntt.py `radix_log`: a transform of 2^19 has 2^16 radix-8
// butterflies, 15.5 warps an SM of the 16 it could hold).
//
// Launch contract: `in`, `out` and `tw` (the stage table, ops/ntt.py
// tw_stages_fwd / _inv) are 16-byte aligned; `out` is distinct from `in`
// in the first pass (s0 = 0, which reads through the bit reversal) and
// the same buffer in a later one; the caller passes PyTorch's current
// stream and raises if the returned cudaError_t is not 0 (a shared-memory
// size the card refuses among them).
#include <cstdint>

#include "ntt_pass.cuh"

template <int R, bool kFirst>
__global__ void __launch_bounds__(PASS_MAX_THREADS, 1)
    ntt_pass_kernel(const uint32_t* in, uint32_t* out, const uint32_t* __restrict__ tw, int log_n, int s0, int cnt,
                    int log_c) {
  extern __shared__ __align__(128) uint4 pass_sh[];
  // launched early behind the kernel before it (programmatic dependent
  // launch): that kernel's results are complete and visible after this
  // wait; the next pass may be scheduled from here on
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t row = (size_t)blockIdx.y << (log_n + 3);  // this transform's first limb
  ntt_pass_block<R, kFirst>(pass_sh, in + row, out + row, tw, log_n, s0, cnt, log_c);
}

template <int R, bool kFirst>
static int launch(const void* in, void* out, const void* tw, int log_n, int s0, int cnt, int log_c, int batch,
                  bool pdl, void* stream) {
  const int lt = cnt + log_c;
  const size_t shmem = (size_t)32 << lt;
  // above 48 KB only after this opt-in, made once a card for the largest
  // tile (the card refuses more than it has)
  static bool opted[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && shmem > 48 * 1024 && (dev >= 64 || !opted[dev])) {
    err = cudaFuncSetAttribute((const void*)ntt_pass_kernel<R, kFirst>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 32 << PASS_MAX_TILE_LOG);
    if (err == cudaSuccess && dev < 64) opted[dev] = true;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << (log_n - lt), (unsigned)batch);
  cfg.blockDim = dim3(pass_threads(lt, R));
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  // behind the kernel before only where this grid has more blocks than
  // the card holds at once: blocks launched early wait on whichever SMs
  // had room, and a grid of one wave or less may then start lopsided (a
  // transform of 2^18, 256 blocks on 3 x 132 slots, ran 1.2x slower)
  static int slots[64][PASS_MAX_TILE_LOG + 1];
  if (pdl && dev < 64 && !slots[dev][lt]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ntt_pass_kernel<R, kFirst>, pass_threads(lt, R),
                                                      shmem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      per_sm = sms = 0;
    }
    slots[dev][lt] = per_sm * sms > 0 ? per_sm * sms : -1;
  }
  const bool behind = pdl && dev < 64 && slots[dev][lt] > 0 &&
                      (size_t)cfg.gridDim.x * cfg.gridDim.y > (size_t)slots[dev][lt];
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = behind ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, ntt_pass_kernel<R, kFirst>, (const uint32_t*)in, (uint32_t*)out,
                           (const uint32_t*)tw, log_n, s0, cnt, log_c);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

static bool pass_ok(int log_n, int s0, int cnt, int log_c, int radix_log) {
  return cnt >= 1 && log_c >= 0 && s0 >= 0 && s0 + cnt <= log_n && cnt + log_c <= PASS_MAX_TILE_LOG &&
         log_c <= log_n - cnt && (s0 == 0 || log_c <= s0) && radix_log >= 2 && radix_log <= 3 &&
         pass_threads(cnt + log_c, radix_log) <= PASS_MAX_THREADS;
}

static int launch_pass(const void* in, void* out, const void* tw, int log_n, int s0, int cnt, int log_c,
                       int radix_log, int batch, bool pdl, void* stream) {
  if (radix_log == 3)
    return s0 == 0 ? launch<3, true>(in, out, tw, log_n, s0, cnt, log_c, batch, pdl, stream)
                   : launch<3, false>(in, out, tw, log_n, s0, cnt, log_c, batch, pdl, stream);
  return s0 == 0 ? launch<2, true>(in, out, tw, log_n, s0, cnt, log_c, batch, pdl, stream)
                 : launch<2, false>(in, out, tw, log_n, s0, cnt, log_c, batch, pdl, stream);
}

// One pass: stages s0 + 1 .. s0 + cnt of `batch` transforms of 2^log_n
// elements, tiles of 2^log_c groups, radix-8 (radix_log 3) or radix-4
// (radix_log 2) trips
extern "C" int ntt_pass(const void* in, void* out, const void* tw, int log_n, int s0, int cnt, int log_c,
                        int radix_log, int batch, void* stream) {
  if (!pass_ok(log_n, s0, cnt, log_c, radix_log) || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)in | (uintptr_t)out | (uintptr_t)tw) % 16) return (int)cudaErrorMisalignedAddress;
  return launch_pass(in, out, tw, log_n, s0, cnt, log_c, radix_log, batch, false, stream);
}

// A whole transform: `npasses` passes, (s0, cnt, log_c) each in `plan`,
// the first from `in` into `out`, the others in place; where `pdl` is set,
// each pass whose grid exceeds one wave is launched behind the kernel
// before it in the stream (programmatic dependent launch: a pass of this
// kernel lets the next one be scheduled as soon as its own blocks have
// started). Every pass is checked before the first launch.
extern "C" int ntt_transform(const void* in, void* out, const void* tw, int log_n, int npasses, const int* plan,
                             int radix_log, int batch, int pdl, void* stream) {
  if (npasses < 1 || plan[0] != 0 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  for (int k = 0, s = 0; k < npasses; s += plan[3 * k + 1], k++)
    if (plan[3 * k] != s || !pass_ok(log_n, s, plan[3 * k + 1], plan[3 * k + 2], radix_log) ||
        (k == npasses - 1 && s + plan[3 * k + 1] != log_n))
      return (int)cudaErrorInvalidValue;
  if (((uintptr_t)in | (uintptr_t)out | (uintptr_t)tw) % 16) return (int)cudaErrorMisalignedAddress;
  for (int k = 0; k < npasses; k++) {
    const int err = launch_pass(k ? out : in, out, tw, log_n, plan[3 * k], plan[3 * k + 1], plan[3 * k + 2],
                                radix_log, batch, pdl, stream);
    if (err) return err;
  }
  return 0;
}
