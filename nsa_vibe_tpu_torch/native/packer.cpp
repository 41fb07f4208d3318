// Native byte-LM data path: streaming tokenize + fixed-length packing
// (the port's own copy of nsa_vibe_tpu/native/packer.cpp).
//
// The trainer streams the corpus through tokenize + pack on the host; in
// Python that costs an allocation and a copy per document. This library
// keeps one ring buffer in C and emits [batch, seq_len+1] int32 rows with
// no Python-side copies.
//
// C ABI (ctypes):
//   packer_new(seq_len, batch)      -> opaque handle
//   packer_feed(h, bytes, n)        -> tokens buffered (byte-level vocab 256)
//   packer_ready(h)                 -> number of full batches available
//   packer_next(h, out_int32)       -> 1 if a [batch, seq_len+1] row block
//                                      was written, else 0
//   packer_buffered(h)              -> tokens buffered, not yet emitted
//   packer_free(h)
//
// Thread-compatible (one packer per thread); no global state.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Packer {
  int64_t seq_len;
  int64_t batch;
  int64_t need;              // batch * (seq_len + 1) tokens per emission
  std::vector<int32_t> buf;  // rolling token buffer
  int64_t head = 0;          // consumed prefix (compacted lazily)

  Packer(int64_t s, int64_t b) : seq_len(s), batch(b), need(b * (s + 1)) {
    buf.reserve(static_cast<size_t>(need) * 2);
  }

  int64_t available() const { return static_cast<int64_t>(buf.size()) - head; }

  void compact() {
    if (head == 0) return;
    buf.erase(buf.begin(), buf.begin() + head);
    head = 0;
  }

  void feed(const uint8_t* bytes, int64_t n) {
    // amortized compaction: only when the dead prefix dominates
    if (head > need * 4) compact();
    size_t old = buf.size();
    buf.resize(old + static_cast<size_t>(n));
    int32_t* dst = buf.data() + old;
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<int32_t>(bytes[i]);
  }

  int64_t ready() const { return available() / need; }

  bool next(int32_t* out) {
    if (available() < need) return false;
    std::memcpy(out, buf.data() + head,
                static_cast<size_t>(need) * sizeof(int32_t));
    head += need;
    return true;
  }
};

}  // namespace

extern "C" {

void* packer_new(int64_t seq_len, int64_t batch) {
  if (seq_len <= 0 || batch <= 0) return nullptr;
  return new Packer(seq_len, batch);
}

void packer_feed(void* h, const uint8_t* bytes, int64_t n) {
  if (h && bytes && n > 0) static_cast<Packer*>(h)->feed(bytes, n);
}

int64_t packer_ready(void* h) {
  return h ? static_cast<Packer*>(h)->ready() : 0;
}

int32_t packer_next(void* h, int32_t* out) {
  if (!h || !out) return 0;
  return static_cast<Packer*>(h)->next(out) ? 1 : 0;
}

int64_t packer_buffered(void* h) {
  return h ? static_cast<Packer*>(h)->available() : 0;
}

void packer_free(void* h) { delete static_cast<Packer*>(h); }

}  // extern "C"
