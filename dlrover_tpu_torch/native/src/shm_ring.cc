// Shared-memory ring buffer for coworker-style batch transport.
//
// The port's own copy of dlrover_tpu/native/src/shm_ring.cc: the segment
// layout (control block, magic, slots) is the same, so a ring created by
// either package's library is attached by the other's.
//
// Role parity: atorch's shared-memory data path
// (atorch/atorch/data/shm_context.py:20-682 + shm_dataloader.py:38-220):
// CPU preprocessing processes produce ready batches into shared memory and
// trainer processes consume them without pickling through pipes. The
// reference implements this in Python over multiprocessing.shared_memory;
// here the hot path (slot bookkeeping, blocking, copies) is C++ and the
// Python side only moves numpy views (see native/shm_ring.py).
//
// Design: one POSIX shm segment = control block + N fixed-size slots.
// MPMC-safe via a process-shared pthread mutex + two condvars (not-full /
// not-empty); producers and consumers may be different processes. All
// blocking calls take a timeout so an elastic restart never wedges on a
// dead peer.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x444c52544f525251ull;  // "DLRTORRQ"

struct ControlBlock {
  uint64_t magic;
  uint64_t slot_size;   // payload capacity per slot
  uint64_t n_slots;
  uint64_t head;        // next slot to write
  uint64_t tail;        // next slot to read
  uint64_t count;       // filled slots
  uint64_t closed;      // producer signalled end-of-stream
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

struct SlotHeader {
  uint64_t len;
};

struct Ring {
  ControlBlock* ctrl;
  uint8_t* slots;       // n_slots * (sizeof(SlotHeader) + slot_size)
  size_t map_size;
  bool owner;
  char name[256];
};

size_t slot_stride(const ControlBlock* c) {
  return sizeof(SlotHeader) + c->slot_size;
}

uint8_t* slot_at(Ring* r, uint64_t idx) {
  return r->slots + idx * slot_stride(r->ctrl);
}

void deadline_after_ms(timespec* ts, long timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure (errno holds the cause).
void* shm_ring_create(const char* name, uint64_t slot_size,
                      uint64_t n_slots) {
  size_t map_size =
      sizeof(ControlBlock) + n_slots * (sizeof(SlotHeader) + slot_size);
  shm_unlink(name);  // stale segment from a crashed predecessor
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }

  auto* ctrl = static_cast<ControlBlock*>(mem);
  std::memset(ctrl, 0, sizeof(ControlBlock));
  ctrl->slot_size = slot_size;
  ctrl->n_slots = n_slots;

  pthread_mutexattr_t mattr;
  pthread_mutexattr_init(&mattr);
  pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&ctrl->mutex, &mattr);
  pthread_mutexattr_destroy(&mattr);

  pthread_condattr_t cattr;
  pthread_condattr_init(&cattr);
  pthread_condattr_setpshared(&cattr, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&ctrl->not_full, &cattr);
  pthread_cond_init(&ctrl->not_empty, &cattr);
  pthread_condattr_destroy(&cattr);

  ctrl->magic = kMagic;

  auto* ring = new Ring();
  ring->ctrl = ctrl;
  ring->slots = static_cast<uint8_t*>(mem) + sizeof(ControlBlock);
  ring->map_size = map_size;
  ring->owner = true;
  std::strncpy(ring->name, name, sizeof(ring->name) - 1);
  return ring;
}

void* shm_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* ctrl = static_cast<ControlBlock*>(mem);
  if (ctrl->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    errno = EINVAL;
    return nullptr;
  }
  auto* ring = new Ring();
  ring->ctrl = ctrl;
  ring->slots = static_cast<uint8_t*>(mem) + sizeof(ControlBlock);
  ring->map_size = static_cast<size_t>(st.st_size);
  ring->owner = false;
  std::strncpy(ring->name, name, sizeof(ring->name) - 1);
  return ring;
}

// Lock helper tolerating a peer that died while holding the mutex.
static int lock_robust(ControlBlock* c) {
  int rc = pthread_mutex_lock(&c->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&c->mutex);
    rc = 0;
  }
  return rc;
}

// 0 ok; ETIMEDOUT on timeout; EMSGSIZE if len > slot_size; EPIPE if closed.
int shm_ring_push(void* handle, const uint8_t* data, uint64_t len,
                  long timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  ControlBlock* c = r->ctrl;
  if (len > c->slot_size) return EMSGSIZE;
  if (lock_robust(c) != 0) return EINVAL;
  timespec deadline;
  deadline_after_ms(&deadline, timeout_ms);
  while (c->count == c->n_slots && !c->closed) {
    int rc = pthread_cond_timedwait(&c->not_full, &c->mutex, &deadline);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&c->mutex);
      return ETIMEDOUT;
    }
    // a peer died holding the mutex: mark it consistent or the mutex is
    // permanently unrecoverable for every survivor
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&c->mutex);
  }
  if (c->closed) {
    pthread_mutex_unlock(&c->mutex);
    return EPIPE;
  }
  uint8_t* slot = slot_at(r, c->head % c->n_slots);
  reinterpret_cast<SlotHeader*>(slot)->len = len;
  std::memcpy(slot + sizeof(SlotHeader), data, len);
  c->head++;
  c->count++;
  pthread_cond_signal(&c->not_empty);
  pthread_mutex_unlock(&c->mutex);
  return 0;
}

// Returns payload length popped into out; -ETIMEDOUT / -EPIPE (closed and
// drained) / -EMSGSIZE (cap too small) as negatives.
long shm_ring_pop(void* handle, uint8_t* out, uint64_t cap,
                  long timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  ControlBlock* c = r->ctrl;
  if (lock_robust(c) != 0) return -EINVAL;
  timespec deadline;
  deadline_after_ms(&deadline, timeout_ms);
  while (c->count == 0 && !c->closed) {
    int rc = pthread_cond_timedwait(&c->not_empty, &c->mutex, &deadline);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&c->mutex);
      return -ETIMEDOUT;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&c->mutex);
  }
  if (c->count == 0 && c->closed) {
    pthread_mutex_unlock(&c->mutex);
    return -EPIPE;
  }
  uint8_t* slot = slot_at(r, c->tail % c->n_slots);
  uint64_t len = reinterpret_cast<SlotHeader*>(slot)->len;
  if (len > cap) {
    pthread_mutex_unlock(&c->mutex);
    return -EMSGSIZE;
  }
  std::memcpy(out, slot + sizeof(SlotHeader), len);
  c->tail++;
  c->count--;
  pthread_cond_signal(&c->not_full);
  pthread_mutex_unlock(&c->mutex);
  return static_cast<long>(len);
}

long shm_ring_slot_size(void* handle) {
  return static_cast<long>(static_cast<Ring*>(handle)->ctrl->slot_size);
}

long shm_ring_size(void* handle) {
  auto* r = static_cast<Ring*>(handle);
  if (lock_robust(r->ctrl) != 0) return -EINVAL;
  long n = static_cast<long>(r->ctrl->count);
  pthread_mutex_unlock(&r->ctrl->mutex);
  return n;
}

// Signal end-of-stream: consumers drain remaining slots then get EPIPE.
void shm_ring_close(void* handle) {
  auto* r = static_cast<Ring*>(handle);
  if (lock_robust(r->ctrl) == 0) {
    r->ctrl->closed = 1;
    pthread_cond_broadcast(&r->ctrl->not_empty);
    pthread_cond_broadcast(&r->ctrl->not_full);
    pthread_mutex_unlock(&r->ctrl->mutex);
  }
}

void shm_ring_free(void* handle) {
  auto* r = static_cast<Ring*>(handle);
  bool owner = r->owner;
  char name[256];
  std::strncpy(name, r->name, sizeof(name));
  munmap(static_cast<void*>(r->ctrl), r->map_size);
  if (owner) shm_unlink(name);
  delete r;
}

}  // extern "C"
