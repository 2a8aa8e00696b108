// Shared-memory observation ring: zero-copy frame transport between
// simulator worker processes and the rollout runner.
//
// The reference moves observations from sampler subprocesses to the learner
// through Python multiprocessing pipes (pickle + two copies per camera frame;
// AllenAct VectorSampledTasks internals — SURVEY §2.4). This native ring
// gives each stream a single-producer/single-consumer shared-memory queue:
// the worker writes the frame bytes once into a mapped slot, the consumer
// reads them in place (numpy frombuffer view) and releases the slot.
//
// Layout per ring (one ring per stream):
//   [RingHeader][slot 0][slot 1]...[slot n-1]
//   each slot: [SlotHeader][payload bytes]
// Writer spins (with nanosleep backoff) when full; reader when empty —
// acquire/release semantics via C11 atomics on head/tail.
//
// C ABI so Python binds with ctypes (no pybind11 dependency).
//
// The port's copy of native/obs_ring.cpp, with the same layout and ABI, so a
// ring opened by either package's binding is read by the other's.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingHeader {
  uint64_t magic;
  uint32_t n_slots;
  uint32_t slot_bytes;  // payload capacity per slot
  std::atomic<uint64_t> head;  // next slot to write (producer-owned)
  std::atomic<uint64_t> tail;  // next slot to read (consumer-owned)
};

struct SlotHeader {
  uint32_t len;  // payload length actually written
  uint32_t tag;  // caller-defined (e.g. step index) for sanity checks
};

constexpr uint64_t kMagic = 0x53414645564c4131ULL;  // "SAFEVLA1"

struct Ring {
  RingHeader* hdr;
  uint8_t* slots;
  size_t total_bytes;
  int fd;
  bool owner;
  char name[256];
};

inline size_t slot_stride(uint32_t slot_bytes) {
  return sizeof(SlotHeader) + ((slot_bytes + 63) & ~size_t(63));
}

inline uint8_t* slot_at(Ring* r, uint64_t idx) {
  return r->slots + (idx % r->hdr->n_slots) * slot_stride(r->hdr->slot_bytes);
}

void backoff(unsigned spin) {
  if (spin < 64) return;
  timespec ts{0, spin < 1024 ? 10'000 : 200'000};  // 10us then 200us
  nanosleep(&ts, nullptr);
}

}  // namespace

extern "C" {

// Create (owner=1) or attach (owner=0) a ring. Returns nullptr on failure.
void* obs_ring_open(const char* name, uint32_t n_slots, uint32_t slot_bytes,
                    int create) {
  size_t total =
      sizeof(RingHeader) + size_t(n_slots) * slot_stride(slot_bytes);
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    if (create) shm_unlink(name);
    return nullptr;
  }
  Ring* r = new Ring();
  r->hdr = reinterpret_cast<RingHeader*>(mem);
  r->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(RingHeader);
  r->total_bytes = total;
  r->fd = fd;
  r->owner = create != 0;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  if (create) {
    r->hdr->magic = kMagic;
    r->hdr->n_slots = n_slots;
    r->hdr->slot_bytes = slot_bytes;
    r->hdr->head.store(0, std::memory_order_relaxed);
    r->hdr->tail.store(0, std::memory_order_relaxed);
  } else if (r->hdr->magic != kMagic || r->hdr->n_slots != n_slots ||
             r->hdr->slot_bytes != slot_bytes) {
    munmap(mem, total);
    close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

// Producer: copy `len` bytes into the next slot. Blocks (spin+sleep) while
// full, up to timeout_us; returns 0 on success, -1 on timeout.
int obs_ring_push(void* ring, const uint8_t* data, uint32_t len, uint32_t tag,
                  int64_t timeout_us) {
  Ring* r = static_cast<Ring*>(ring);
  if (len > r->hdr->slot_bytes) return -2;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  unsigned spin = 0;
  int64_t waited_ns = 0;
  while (head - r->hdr->tail.load(std::memory_order_acquire) >=
         r->hdr->n_slots) {
    backoff(++spin);
    if (spin >= 1024) waited_ns += 200'000;
    if (timeout_us >= 0 && waited_ns / 1000 > timeout_us) return -1;
  }
  uint8_t* slot = slot_at(r, head);
  auto* sh = reinterpret_cast<SlotHeader*>(slot);
  sh->len = len;
  sh->tag = tag;
  std::memcpy(slot + sizeof(SlotHeader), data, len);
  r->hdr->head.store(head + 1, std::memory_order_release);
  return 0;
}

// Consumer: wait for the next slot; returns payload length (>=0) and fills
// *out_ptr with a pointer INTO shared memory (valid until obs_ring_release).
// Returns -1 on timeout.
int64_t obs_ring_peek(void* ring, uint8_t** out_ptr, uint32_t* out_tag,
                      int64_t timeout_us) {
  Ring* r = static_cast<Ring*>(ring);
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  unsigned spin = 0;
  int64_t waited_ns = 0;
  while (r->hdr->head.load(std::memory_order_acquire) == tail) {
    backoff(++spin);
    if (spin >= 1024) waited_ns += 200'000;
    if (timeout_us >= 0 && waited_ns / 1000 > timeout_us) return -1;
  }
  uint8_t* slot = slot_at(r, tail);
  auto* sh = reinterpret_cast<SlotHeader*>(slot);
  *out_ptr = slot + sizeof(SlotHeader);
  if (out_tag) *out_tag = sh->tag;
  return sh->len;
}

// Consumer: release the slot returned by the last peek.
void obs_ring_release(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  r->hdr->tail.fetch_add(1, std::memory_order_release);
}

// Number of filled slots (diagnostics).
uint32_t obs_ring_size(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  return (uint32_t)(r->hdr->head.load(std::memory_order_acquire) -
                    r->hdr->tail.load(std::memory_order_acquire));
}

void obs_ring_close(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  munmap(r->hdr, r->total_bytes);
  close(r->fd);
  if (r->owner) shm_unlink(r->name);
  delete r;
}

}  // extern "C"
