// Parameter-server table engine — native core.
//
// Reference parity: the brpc parameter server's table layer
// (paddle/fluid/distributed/ps/table/: memory_sparse_table, dense tables,
// and the "accessor" fused embedding+optimizer update). This is an
// original implementation for the TPU framework: sharded hash-map sparse
// tables and flat dense tables whose PUSH applies the optimizer update
// (SGD / AdaGrad / Adam) in C++, so the Python transport layer never
// touches per-row math. Rows are initialized on first PULL with a
// deterministic per-key uniform(-range, range) draw (splitmix64 on
// key ^ seed) — no RNG state to serialize.
//
// C ABI only (ctypes-bound; no pybind11 in this image).

#include <fcntl.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNumShards = 16;

enum OptKind : int { kSGD = 0, kAdaGrad = 1, kAdam = 2 };

struct OptConfig {
  int kind = kSGD;
  float lr = 0.01f;
  float beta1 = 0.9f;
  float beta2 = 0.999f;
  float eps = 1e-8f;
};

// Optimizer state layout per row, appended after the `dim` weights:
//   SGD:     nothing
//   AdaGrad: dim (accumulated g^2)
//   Adam:    2*dim (m, v) + 1 (step count t)
int SlotWidth(const OptConfig& c, int dim) {
  switch (c.kind) {
    case kAdaGrad:
      return dim;
    case kAdam:
      return 2 * dim + 1;
    default:
      return 0;
  }
}

void ApplyUpdate(const OptConfig& c, int dim, float* w, float* slots,
                 const float* g) {
  switch (c.kind) {
    case kSGD:
      for (int i = 0; i < dim; ++i) w[i] -= c.lr * g[i];
      break;
    case kAdaGrad:
      for (int i = 0; i < dim; ++i) {
        slots[i] += g[i] * g[i];
        w[i] -= c.lr * g[i] / (std::sqrt(slots[i]) + c.eps);
      }
      break;
    case kAdam: {
      float* m = slots;
      float* v = slots + dim;
      float& t = slots[2 * dim];
      t += 1.0f;
      const float bc1 = 1.0f - std::pow(c.beta1, t);
      const float bc2 = 1.0f - std::pow(c.beta2, t);
      for (int i = 0; i < dim; ++i) {
        m[i] = c.beta1 * m[i] + (1.0f - c.beta1) * g[i];
        v[i] = c.beta2 * v[i] + (1.0f - c.beta2) * g[i] * g[i];
        const float mh = m[i] / bc1;
        const float vh = v[i] / bc2;
        w[i] -= c.lr * mh / (std::sqrt(vh) + c.eps);
      }
      break;
    }
  }
}

uint64_t SplitMix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

float UniformFromBits(uint64_t bits, float range) {
  // top 24 bits → [0, 1) → [-range, range)
  const float u = static_cast<float>(bits >> 40) / 16777216.0f;
  return (2.0f * u - 1.0f) * range;
}

class SparseTable {
 public:
  SparseTable(int dim, OptConfig opt, float init_range, uint64_t seed)
      : dim_(dim),
        opt_(opt),
        row_width_(dim + SlotWidth(opt, dim)),
        init_range_(init_range),
        seed_(seed) {}

  void Pull(const uint64_t* keys, int64_t n, float* out) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard(keys[i]);
      std::lock_guard<std::mutex> g(s.mu);
      std::vector<float>& row = RowLocked(s, keys[i]);
      std::memcpy(out + i * dim_, row.data(), dim_ * sizeof(float));
    }
  }

  void Push(const uint64_t* keys, int64_t n, const float* grads) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard(keys[i]);
      std::lock_guard<std::mutex> g(s.mu);
      std::vector<float>& row = RowLocked(s, keys[i]);
      ApplyUpdate(opt_, dim_, row.data(), row.data() + dim_,
                  grads + i * dim_);
    }
  }

  int64_t Size() const {
    int64_t total = 0;
    for (const auto& s : shards_) total += static_cast<int64_t>(s.map.size());
    return total;
  }

  bool Save(const char* path) const {
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    const uint64_t magic = 0x50535442ull;  // "PSTB"
    int64_t rows = Size();
    std::fwrite(&magic, 8, 1, f);
    std::fwrite(&dim_, sizeof(int), 1, f);
    std::fwrite(&row_width_, sizeof(int), 1, f);
    std::fwrite(&rows, 8, 1, f);
    for (const auto& s : shards_) {
      for (const auto& kv : s.map) {
        std::fwrite(&kv.first, 8, 1, f);
        std::fwrite(kv.second.data(), sizeof(float), row_width_, f);
      }
    }
    std::fclose(f);
    return true;
  }

  bool Load(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    uint64_t magic = 0;
    int dim = 0, rw = 0;
    int64_t rows = 0;
    if (std::fread(&magic, 8, 1, f) != 1 || magic != 0x50535442ull ||
        std::fread(&dim, sizeof(int), 1, f) != 1 || dim != dim_ ||
        std::fread(&rw, sizeof(int), 1, f) != 1 || rw != row_width_ ||
        std::fread(&rows, 8, 1, f) != 1) {
      std::fclose(f);
      return false;
    }
    for (int64_t i = 0; i < rows; ++i) {
      uint64_t key;
      std::vector<float> row(row_width_);
      if (std::fread(&key, 8, 1, f) != 1 ||
          std::fread(row.data(), sizeof(float), row_width_, f) !=
              static_cast<size_t>(row_width_)) {
        std::fclose(f);
        return false;
      }
      Shard& s = shard(key);
      std::lock_guard<std::mutex> g(s.mu);
      s.map[key] = std::move(row);
    }
    std::fclose(f);
    return true;
  }

 private:
  struct Shard {
    std::mutex mu;
    std::unordered_map<uint64_t, std::vector<float>> map;
  };

  Shard& shard(uint64_t key) {
    return shards_[SplitMix64(key) % kNumShards];
  }

  std::vector<float>& RowLocked(Shard& s, uint64_t key) {
    auto it = s.map.find(key);
    if (it == s.map.end()) {
      std::vector<float> row(row_width_, 0.0f);
      for (int i = 0; i < dim_; ++i) {
        row[i] = UniformFromBits(SplitMix64(key ^ seed_ ^ (0x9E37ull * i)),
                                 init_range_);
      }
      it = s.map.emplace(key, std::move(row)).first;
    }
    return it->second;
  }

  const int dim_;
  const OptConfig opt_;
  const int row_width_;
  const float init_range_;
  const uint64_t seed_;
  Shard shards_[kNumShards];
};

class DenseTable {
 public:
  DenseTable(int64_t size, OptConfig opt)
      : opt_(opt),
        w_(size, 0.0f),
        slots_(static_cast<size_t>(size) *
                   (opt.kind == kAdaGrad ? 1 : (opt.kind == kAdam ? 2 : 0)) +
               (opt.kind == kAdam ? 1 : 0),
               0.0f) {}

  void SetValues(const float* vals) {
    std::lock_guard<std::mutex> g(mu_);
    std::memcpy(w_.data(), vals, w_.size() * sizeof(float));
  }

  void Pull(float* out) {
    std::lock_guard<std::mutex> g(mu_);
    std::memcpy(out, w_.data(), w_.size() * sizeof(float));
  }

  void Push(const float* grad) {
    std::lock_guard<std::mutex> g(mu_);
    const int64_t n = static_cast<int64_t>(w_.size());
    switch (opt_.kind) {
      case kSGD:
        for (int64_t i = 0; i < n; ++i) w_[i] -= opt_.lr * grad[i];
        break;
      case kAdaGrad:
        for (int64_t i = 0; i < n; ++i) {
          slots_[i] += grad[i] * grad[i];
          w_[i] -= opt_.lr * grad[i] / (std::sqrt(slots_[i]) + opt_.eps);
        }
        break;
      case kAdam: {
        float* m = slots_.data();
        float* v = slots_.data() + n;
        float& t = slots_[2 * n];
        t += 1.0f;
        const float bc1 = 1.0f - std::pow(opt_.beta1, t);
        const float bc2 = 1.0f - std::pow(opt_.beta2, t);
        for (int64_t i = 0; i < n; ++i) {
          m[i] = opt_.beta1 * m[i] + (1.0f - opt_.beta1) * grad[i];
          v[i] = opt_.beta2 * v[i] + (1.0f - opt_.beta2) * grad[i] * grad[i];
          w_[i] -= opt_.lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + opt_.eps);
        }
        break;
      }
    }
  }

  int64_t Size() const { return static_cast<int64_t>(w_.size()); }

 private:
  const OptConfig opt_;
  std::mutex mu_;
  std::vector<float> w_;
  std::vector<float> slots_;
};

// Disk-backed sparse table (reference parity:
// paddle/fluid/distributed/ps/table/ssd_sparse_table.cc — hot rows in
// memory, cold rows on SSD via RocksDB). TPU-framework redesign without a
// RocksDB dependency: a single fixed-record file ([8-byte key | row floats]
// per slot) with an in-memory key->slot index, plus a FIFO-bounded hot-row
// cache. Rows evicted from the cache are written to their slot; rows pulled
// back in are read with pread. Reopening an existing file rebuilds the
// index by scanning records, so the table is durable across restarts.
class FileSparseTable {
 public:
  // validated 24-byte header: reopening with a mismatched dim/optimizer
  // must fail loudly, not stride the file at the wrong record size
  static constexpr uint64_t kMagic = 0x5053464255ull;  // "PSFBU"
  static constexpr int64_t kHeader = 24;  // magic u64 | dim i32 | rw i32 | pad

  FileSparseTable(int dim, OptConfig opt, float init_range, uint64_t seed,
                  const char* path, int64_t max_mem_rows)
      : dim_(dim),
        opt_(opt),
        row_width_(dim + SlotWidth(opt, dim)),
        rec_size_(8 + static_cast<int64_t>(row_width_) * sizeof(float)),
        init_range_(init_range),
        seed_(seed),
        max_mem_rows_(max_mem_rows > 0 ? max_mem_rows : 1) {
    fd_ = ::open(path, O_RDWR | O_CREAT, 0644);
    if (fd_ < 0) return;
    off_t end = ::lseek(fd_, 0, SEEK_END);
    char hdr[kHeader] = {};
    if (end == 0) {  // fresh file: stamp the header
      std::memcpy(hdr, &kMagic, 8);
      std::memcpy(hdr + 8, &dim_, 4);
      std::memcpy(hdr + 12, &row_width_, 4);
      if (::pwrite(fd_, hdr, kHeader, 0) != kHeader) {
        ::close(fd_);
        fd_ = -1;
        return;
      }
      return;
    }
    uint64_t magic = 0;
    int fdim = 0, frw = 0;
    if (::pread(fd_, hdr, kHeader, 0) != kHeader) {
      ::close(fd_);
      fd_ = -1;
      return;
    }
    std::memcpy(&magic, hdr, 8);
    std::memcpy(&fdim, hdr + 8, 4);
    std::memcpy(&frw, hdr + 12, 4);
    if (magic != kMagic || fdim != dim_ || frw != row_width_) {
      ::close(fd_);  // config mismatch -> loud open failure
      fd_ = -1;
      return;
    }
    // rebuild the key->slot index from the existing records
    int64_t n = (end - kHeader) / rec_size_;
    std::vector<char> rec(rec_size_);
    for (int64_t s = 0; s < n; ++s) {
      if (::pread(fd_, rec.data(), rec_size_, kHeader + s * rec_size_) !=
          rec_size_)
        break;
      uint64_t key;
      std::memcpy(&key, rec.data(), 8);
      slot_[key] = s;
    }
    next_slot_ = n;
  }

  ~FileSparseTable() {
    if (fd_ >= 0) {
      FlushLocked();
      ::close(fd_);
    }
  }

  bool ok() const { return fd_ >= 0; }

  void Pull(const uint64_t* keys, int64_t n, float* out) {
    std::lock_guard<std::mutex> g(mu_);
    for (int64_t i = 0; i < n; ++i) {
      std::vector<float>& row = RowLocked(keys[i]);
      std::memcpy(out + i * dim_, row.data(), dim_ * sizeof(float));
    }
  }

  void Push(const uint64_t* keys, int64_t n, const float* grads) {
    std::lock_guard<std::mutex> g(mu_);
    for (int64_t i = 0; i < n; ++i) {
      std::vector<float>& row = RowLocked(keys[i]);
      ApplyUpdate(opt_, dim_, row.data(), row.data() + dim_,
                  grads + i * dim_);
    }
  }

  int64_t Size() {
    std::lock_guard<std::mutex> g(mu_);
    int64_t on_disk = static_cast<int64_t>(slot_.size());
    for (const auto& kv : mem_)
      if (slot_.find(kv.first) == slot_.end()) ++on_disk;
    return on_disk;
  }

  int64_t MemRows() {
    std::lock_guard<std::mutex> g(mu_);
    return static_cast<int64_t>(mem_.size());
  }

  bool Flush() {
    std::lock_guard<std::mutex> g(mu_);
    return FlushLocked();
  }

 private:
  std::vector<float>& RowLocked(uint64_t key) {
    auto it = mem_.find(key);
    if (it != mem_.end()) return it->second;
    EvictLocked();
    std::vector<float> row(row_width_, 0.0f);
    auto st = slot_.find(key);
    if (st != slot_.end()) {
      ::pread(fd_, row.data(), row_width_ * sizeof(float),
              kHeader + st->second * rec_size_ + 8);
    } else {
      for (int i = 0; i < dim_; ++i) {
        row[i] = UniformFromBits(SplitMix64(key ^ seed_ ^ (0x9E37ull * i)),
                                 init_range_);
      }
    }
    it = mem_.emplace(key, std::move(row)).first;
    fifo_.push_back(key);
    return it->second;
  }

  void EvictLocked() {
    while (static_cast<int64_t>(mem_.size()) >= max_mem_rows_ &&
           !fifo_.empty()) {
      uint64_t victim = fifo_.front();
      fifo_.pop_front();
      auto it = mem_.find(victim);
      if (it == mem_.end()) continue;  // already evicted duplicate
      WriteRowLocked(victim, it->second);
      mem_.erase(it);
    }
  }

  void WriteRowLocked(uint64_t key, const std::vector<float>& row) {
    auto st = slot_.find(key);
    int64_t s = (st != slot_.end()) ? st->second : next_slot_++;
    slot_[key] = s;
    std::vector<char> rec(rec_size_);
    std::memcpy(rec.data(), &key, 8);
    std::memcpy(rec.data() + 8, row.data(), row_width_ * sizeof(float));
    if (::pwrite(fd_, rec.data(), rec_size_, kHeader + s * rec_size_) !=
        rec_size_) {
      // eviction write failed (ENOSPC, short write): the slot now holds
      // garbage. Poison the table — Flush() reports it and Python raises.
      io_error_ = true;
    }
  }

  bool FlushLocked() {
    for (const auto& kv : mem_) WriteRowLocked(kv.first, kv.second);
    return !io_error_ && ::fsync(fd_) == 0;
  }

  const int dim_;
  const OptConfig opt_;
  const int row_width_;
  const int64_t rec_size_;
  const float init_range_;
  const uint64_t seed_;
  const int64_t max_mem_rows_;
  int fd_ = -1;
  bool io_error_ = false;
  int64_t next_slot_ = 0;
  std::mutex mu_;
  std::unordered_map<uint64_t, std::vector<float>> mem_;
  std::unordered_map<uint64_t, int64_t> slot_;
  std::deque<uint64_t> fifo_;
};

}  // namespace

extern "C" {

void* pd_ps_sparse_create(int dim, int opt_kind, float lr, float beta1,
                          float beta2, float eps, float init_range,
                          uint64_t seed) {
  OptConfig c{opt_kind, lr, beta1, beta2, eps};
  return new SparseTable(dim, c, init_range, seed);
}

void pd_ps_sparse_free(void* h) { delete static_cast<SparseTable*>(h); }

void pd_ps_sparse_pull(void* h, const uint64_t* keys, int64_t n, float* out) {
  static_cast<SparseTable*>(h)->Pull(keys, n, out);
}

void pd_ps_sparse_push(void* h, const uint64_t* keys, int64_t n,
                       const float* grads) {
  static_cast<SparseTable*>(h)->Push(keys, n, grads);
}

int64_t pd_ps_sparse_size(void* h) {
  return static_cast<SparseTable*>(h)->Size();
}

int pd_ps_sparse_save(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->Save(path) ? 0 : -1;
}

int pd_ps_sparse_load(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->Load(path) ? 0 : -1;
}

void* pd_ps_dense_create(int64_t size, int opt_kind, float lr, float beta1,
                         float beta2, float eps) {
  OptConfig c{opt_kind, lr, beta1, beta2, eps};
  return new DenseTable(size, c);
}

void pd_ps_dense_free(void* h) { delete static_cast<DenseTable*>(h); }

void pd_ps_dense_set(void* h, const float* vals) {
  static_cast<DenseTable*>(h)->SetValues(vals);
}

void pd_ps_dense_pull(void* h, float* out) {
  static_cast<DenseTable*>(h)->Pull(out);
}

void pd_ps_dense_push(void* h, const float* grad) {
  static_cast<DenseTable*>(h)->Push(grad);
}

int64_t pd_ps_dense_size(void* h) {
  return static_cast<DenseTable*>(h)->Size();
}

void* pd_ps_file_create(int dim, int opt_kind, float lr, float beta1,
                        float beta2, float eps, float init_range,
                        uint64_t seed, const char* path,
                        int64_t max_mem_rows) {
  OptConfig opt{static_cast<OptKind>(opt_kind), lr, beta1, beta2, eps};
  auto* t = new FileSparseTable(dim, opt, init_range, seed, path,
                                max_mem_rows);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}

void pd_ps_file_free(void* h) { delete static_cast<FileSparseTable*>(h); }

void pd_ps_file_pull(void* h, const uint64_t* keys, int64_t n, float* out) {
  static_cast<FileSparseTable*>(h)->Pull(keys, n, out);
}

void pd_ps_file_push(void* h, const uint64_t* keys, int64_t n,
                     const float* grads) {
  static_cast<FileSparseTable*>(h)->Push(keys, n, grads);
}

int64_t pd_ps_file_size(void* h) {
  return static_cast<FileSparseTable*>(h)->Size();
}

int64_t pd_ps_file_mem_rows(void* h) {
  return static_cast<FileSparseTable*>(h)->MemRows();
}

int pd_ps_file_flush(void* h) {
  return static_cast<FileSparseTable*>(h)->Flush() ? 0 : 1;
}

}  // extern "C"
