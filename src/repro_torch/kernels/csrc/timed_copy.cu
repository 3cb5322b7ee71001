// Host code of the transfer engine's copy clock (pool/transfer.py): copies
// queued back to back between two timing events in one call, so that no
// other thread of the caller's process can put anything between them on the
// stream, and the device meets the events right before the first copy and
// right after the last.

#include <cuda_runtime.h>

extern "C" int hyperoffload_timed_copies(void* const* dst,
                                         const void* const* src,
                                         const size_t* nbytes, int n,
                                         void* begin, void* end,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaEventRecord(static_cast<cudaEvent_t>(begin), s);
  for (int i = 0; err == cudaSuccess && i < n; ++i)
    err = cudaMemcpyAsync(dst[i], src[i], nbytes[i], cudaMemcpyDefault, s);
  if (err == cudaSuccess)
    err = cudaEventRecord(static_cast<cudaEvent_t>(end), s);
  return static_cast<int>(err);
}

// The milliseconds from ``anchor`` to ``begin`` and from ``begin`` to
// ``end`` (three completed timing events) into ms[0] and ms[1].
extern "C" int hyperoffload_copy_times(void* anchor, void* begin, void* end,
                                       float* ms) {
  cudaError_t err = cudaEventElapsedTime(
      ms, static_cast<cudaEvent_t>(anchor), static_cast<cudaEvent_t>(begin));
  if (err == cudaSuccess)
    err = cudaEventElapsedTime(ms + 1, static_cast<cudaEvent_t>(begin),
                               static_cast<cudaEvent_t>(end));
  return static_cast<int>(err);
}
