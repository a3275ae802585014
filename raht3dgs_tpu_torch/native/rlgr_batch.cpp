// The port's RLGR library: the coder of rlgr.cpp (a byte-identical copy of
// the JAX package's, its batch entries and thread pool included) in this
// translation unit, and batch entry points that can report each job's
// wall nanoseconds for the port's tracing (utils/timing.py). A job's
// timing reads the clock around it and changes none of its bytes.

#include "rlgr.cpp"

#include <chrono>

namespace {

// fn(), and with job_ns its wall nanoseconds into job_ns[j]
template <typename Fn>
int timed_job(uint64_t* job_ns, size_t j, Fn&& fn) {
  if (!job_ns) return fn();
  auto t0 = std::chrono::steady_clock::now();
  int rc = fn();
  job_ns[j] = static_cast<uint64_t>(std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now() - t0).count());
  return rc;
}

}  // namespace

extern "C" {

// rlgr_encode_batch32, and with a non-null job_ns each job's wall
// nanoseconds into job_ns[j].
int rlgr_encode_batch32_timed(const int32_t* data, const size_t* offsets,
                              const size_t* ns, size_t count, int flag_signed,
                              int n_threads, uint8_t** outs, size_t* out_lens,
                              uint64_t* job_ns) {
  std::atomic<int> rc{0};
  run_jobs(count, n_threads, [&](size_t j) {
    if (timed_job(job_ns, j, [&] {
          return rlgr_encode32(data + offsets[j], ns[j], flag_signed, &outs[j],
                               &out_lens[j]);
        }) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

// rlgr_decode_batch32, with job_ns as for the encoder.
int rlgr_decode_batch32_timed(const uint8_t* buf, const size_t* buf_offsets,
                              const size_t* buf_lens, const size_t* ns,
                              const size_t* out_offsets, size_t count,
                              int flag_signed, int n_threads, int32_t* out,
                              uint64_t* job_ns) {
  std::atomic<int> rc{0};
  run_jobs(count, n_threads, [&](size_t j) {
    if (timed_job(job_ns, j, [&] {
          return rlgr_decode32(buf + buf_offsets[j], buf_lens[j], flag_signed,
                               out + out_offsets[j], ns[j]);
        }) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

// The threads run_jobs starts for `count` jobs and `n_threads`: n_threads,
// or the hardware concurrency when n_threads <= 0, at most one a job.
size_t rlgr_pool_size(size_t count, int n_threads) {
  size_t hw = std::thread::hardware_concurrency();
  size_t t = n_threads > 0 ? static_cast<size_t>(n_threads) : (hw ? hw : 1);
  return t > count ? count : t;
}

}  // extern "C"
