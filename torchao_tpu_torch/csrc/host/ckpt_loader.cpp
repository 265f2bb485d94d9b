// Native checkpoint streaming loader: the port's copy of the JAX package's
// csrc/ckpt_loader.cpp, built with g++ into torchao_tpu_torch/_build/.
//
// Tensors live in one large raw `data.bin` (the reference's mmap load path,
// gpt-fast `_load_model`, torchao/_models/llama/generate.py:241-252); this
// loader mmaps the file and copies the requested ranges into
// caller-provided buffers with a thread pool, far beyond a single-threaded
// read() loop.
//
// C ABI (consumed via ctypes from torchao_tpu_torch/io/native_loader.py):
//   tq_load_ranges(path, offsets, nbytes, dsts, n, threads) -> 0 on ok
//   tq_file_size(path) -> size or -1

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <atomic>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

int64_t tq_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Copy n ranges [offsets[i], offsets[i]+nbytes[i]) of `path` into dsts[i].
// Work is split at ~8MB granularity across `threads` workers so large
// tensors are copied by many threads, not one.
int tq_load_ranges(const char* path, const int64_t* offsets,
                   const int64_t* nbytes, void** dsts, int64_t n,
                   int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -2;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -3; }
  size_t fsize = static_cast<size_t>(st.st_size);
  void* base = mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) { close(fd); return -4; }
  madvise(base, fsize, MADV_SEQUENTIAL);

  struct Chunk { const char* src; char* dst; size_t len; };
  std::vector<Chunk> chunks;
  const size_t kGrain = 8u << 20;  // 8 MB
  for (int64_t i = 0; i < n; ++i) {
    if (offsets[i] < 0 ||
        static_cast<size_t>(offsets[i] + nbytes[i]) > fsize) {
      munmap(base, fsize); close(fd); return -5;
    }
    const char* src = static_cast<const char*>(base) + offsets[i];
    char* dst = static_cast<char*>(dsts[i]);
    size_t remaining = static_cast<size_t>(nbytes[i]);
    size_t done = 0;
    while (remaining > 0) {
      size_t len = remaining < kGrain ? remaining : kGrain;
      chunks.push_back({src + done, dst + done, len});
      done += len;
      remaining -= len;
    }
  }

  if (threads < 1) threads = 1;
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= chunks.size()) break;
      std::memcpy(chunks[i].dst, chunks[i].src, chunks[i].len);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();

  munmap(base, fsize);
  close(fd);
  return 0;
}

}  // extern "C"
