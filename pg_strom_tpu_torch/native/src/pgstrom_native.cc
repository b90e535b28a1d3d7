// pg_strom_tpu native host runtime.
//
// The TPU-native equivalents of the reference's native host components:
//
//   arena        — buddy allocator over an mmap'd segment with guard magics,
//                  redzones and introspection (shmem.c:94-410,1020-1252 analog)
//   restrack     — per-query resource tracking with abort-time sweep
//                  (restrack.c:179-253 analog)
//   mqueue/pool  — MPMC blocking queue + worker thread pool feeding the
//                  device runtime (mqueue.c + opencl_serv.c:76-106 analog)
//   loader       — parallel CSV -> struct-of-arrays columnarizer, the
//                  datastore fill path (datastore.c:556-828 analog)
//   pg_crc32     — PostgreSQL's CRC-32 (same polynomial/table construction
//                  as the reference's hash build, opencl_hashjoin.h:21-60)
//   pg_random    — glibc TYPE_3 random() reproduction so PostgreSQL
//                  setseed()/random() fixtures can be regenerated bit-exactly
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <new>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/mman.h>

extern "C" {

// ===========================================================================
// arena: binary-buddy allocator over one mmap'd zone
// ===========================================================================

static constexpr uint32_t BLOCK_MAGIC = 0x5750a11c;   // guard before payload
static constexpr uint32_t REDZONE_MAGIC = 0xdeadbeef; // guard after payload
static constexpr int MIN_ORDER = 8;    // 256 B smallest block
static constexpr int MAX_ORDERS = 32;

struct BlockHeader {
  uint32_t magic;
  uint8_t order;
  uint8_t in_use;
  uint16_t _pad;
  uint64_t req_size;      // caller-requested bytes (redzone lives after)
  uint64_t owner;         // resource-tracking id (query id)
  BlockHeader* next_free; // freelist link while free
};

struct Arena {
  uint8_t* base = nullptr;
  size_t size = 0;
  int top_order = 0;
  BlockHeader* freelists[MAX_ORDERS] = {nullptr};
  std::mutex lock;
  // stats
  std::atomic<uint64_t> n_alloc{0}, n_free{0}, bytes_live{0};
  std::unordered_multimap<uint64_t, BlockHeader*> tracked; // owner -> blocks
};

static int order_for(size_t need) {
  size_t total = need + sizeof(BlockHeader) + sizeof(uint32_t);
  int order = MIN_ORDER;
  while ((1ull << order) < total) order++;
  return order;
}

void* arena_create(uint64_t size) {
  auto* a = new Arena();
  // round size down to a power of two zone
  int top = MIN_ORDER;
  while ((1ull << (top + 1)) <= size) top++;
  a->size = 1ull << top;
  a->top_order = top;
  a->base = (uint8_t*)mmap(nullptr, a->size, PROT_READ | PROT_WRITE,
                           MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (a->base == MAP_FAILED) { delete a; return nullptr; }
  auto* hdr = (BlockHeader*)a->base;
  hdr->magic = BLOCK_MAGIC; hdr->order = (uint8_t)top; hdr->in_use = 0;
  hdr->next_free = nullptr;
  a->freelists[top] = hdr;
  return a;
}

void slab_state_drop(void* ap);   // defined with the slab tier below

void arena_destroy(void* ap) {
  auto* a = (Arena*)ap;
  slab_state_drop(ap);   // a new arena may mmap at the same address —
                         // stale slab freelists would point into it
  if (a->base) munmap(a->base, a->size);
  delete a;
}

static BlockHeader* split_to(Arena* a, int order) {
  if (order > a->top_order) return nullptr;
  if (a->freelists[order]) {
    BlockHeader* b = a->freelists[order];
    a->freelists[order] = b->next_free;
    return b;
  }
  BlockHeader* big = split_to(a, order + 1);
  if (!big) return nullptr;
  // split: big stays at `order`, buddy goes on the freelist
  auto* buddy = (BlockHeader*)((uint8_t*)big + (1ull << order));
  buddy->magic = BLOCK_MAGIC; buddy->order = (uint8_t)order; buddy->in_use = 0;
  buddy->next_free = a->freelists[order];
  a->freelists[order] = buddy;
  big->order = (uint8_t)order;
  return big;
}

void* arena_alloc(void* ap, uint64_t size, uint64_t owner) {
  auto* a = (Arena*)ap;
  int order = order_for(size);
  std::lock_guard<std::mutex> g(a->lock);
  BlockHeader* b = split_to(a, order);
  if (!b) return nullptr;
  b->magic = BLOCK_MAGIC;
  b->in_use = 1;
  b->req_size = size;
  b->owner = owner;
  uint8_t* payload = (uint8_t*)b + sizeof(BlockHeader);
  *(uint32_t*)(payload + size) = REDZONE_MAGIC;
  a->n_alloc++; a->bytes_live += (1ull << order);
  if (owner) a->tracked.emplace(owner, b);
  return payload;
}

// returns: 0 ok; 1 bad magic; 2 redzone overwritten; 3 double free
int arena_check(void* ap, void* p) {
  auto* b = (BlockHeader*)((uint8_t*)p - sizeof(BlockHeader));
  if (b->magic != BLOCK_MAGIC) return 1;
  if (!b->in_use) return 3;
  uint8_t* payload = (uint8_t*)p;
  if (*(uint32_t*)(payload + b->req_size) != REDZONE_MAGIC) return 2;
  return 0;
}

static void free_block_locked(Arena* a, BlockHeader* b) {
  a->n_free++; a->bytes_live -= (1ull << b->order);
  int order = b->order;
  uint8_t* addr = (uint8_t*)b;
  // buddy coalescing
  while (order < a->top_order) {
    size_t off = addr - a->base;
    uint8_t* buddy_addr = a->base + (off ^ (1ull << order));
    auto* buddy = (BlockHeader*)buddy_addr;
    if (buddy->magic != BLOCK_MAGIC || buddy->in_use || buddy->order != order)
      break;
    // unlink buddy from freelist
    BlockHeader** pp = &a->freelists[order];
    bool found = false;
    while (*pp) {
      if (*pp == buddy) { *pp = buddy->next_free; found = true; break; }
      pp = &(*pp)->next_free;
    }
    if (!found) break;
    addr = addr < buddy_addr ? addr : buddy_addr;
    order++;
    ((BlockHeader*)addr)->order = (uint8_t)order;
  }
  auto* m = (BlockHeader*)addr;
  m->magic = BLOCK_MAGIC; m->order = (uint8_t)order; m->in_use = 0;
  m->next_free = a->freelists[order];
  a->freelists[order] = m;
}

// returns arena_check code; frees only when 0
int arena_free(void* ap, void* p) {
  auto* a = (Arena*)ap;
  int rc = arena_check(ap, p);
  if (rc != 0) return rc;
  auto* b = (BlockHeader*)((uint8_t*)p - sizeof(BlockHeader));
  std::lock_guard<std::mutex> g(a->lock);
  if (b->owner) {
    auto range = a->tracked.equal_range(b->owner);
    for (auto it = range.first; it != range.second; ++it)
      if (it->second == b) { a->tracked.erase(it); break; }
  }
  b->in_use = 0;
  free_block_locked(a, b);
  return 0;
}

// abort-time sweep: free everything a query id still owns (restrack analog)
uint64_t arena_release_owner(void* ap, uint64_t owner) {
  auto* a = (Arena*)ap;
  std::lock_guard<std::mutex> g(a->lock);
  uint64_t n = 0;
  auto range = a->tracked.equal_range(owner);
  std::vector<BlockHeader*> blocks;
  for (auto it = range.first; it != range.second; ++it)
    blocks.push_back(it->second);
  a->tracked.erase(owner);
  for (auto* b : blocks) {
    if (b->in_use) { b->in_use = 0; free_block_locked(a, b); n++; }
  }
  return n;
}

void arena_stats(void* ap, uint64_t* out4) {
  auto* a = (Arena*)ap;
  out4[0] = a->n_alloc.load();
  out4[1] = a->n_free.load();
  out4[2] = a->bytes_live.load();
  out4[3] = a->size;
}

// ===========================================================================
// slab tier over buddy blocks — the reference's small-object classes
// (shmem.c:94-100 slab sizes, 359-410 carve/free): fixed-size object
// classes carved from 64KB buddy blocks, each object guarded by a magic +
// class byte header and a trailing redzone word, with per-class counters
// surfaced to pgstrom_slab_info.
// ===========================================================================

static constexpr int N_SLAB_CLASSES = 5;
static constexpr uint64_t SLAB_SIZES[N_SLAB_CLASSES] =
    {96, 240, 512, 1184, 2520};
static constexpr uint32_t SLAB_MAGIC = 0x51abca11;
static constexpr uint64_t SLAB_CHUNK = 1ull << 16;   // carved per refill

struct SlabHeader {
  uint32_t magic;
  uint8_t cls;
  uint8_t in_use;
  uint16_t _pad;
  SlabHeader* next_free;   // freelist link while free
};

struct SlabState {
  std::mutex lock;
  SlabHeader* freelists[N_SLAB_CLASSES] = {nullptr};
  uint64_t n_alloc[N_SLAB_CLASSES] = {0};
  uint64_t n_free[N_SLAB_CLASSES] = {0};
  uint64_t n_objects[N_SLAB_CLASSES] = {0};   // carved capacity
};

static std::unordered_map<void*, SlabState*> g_slabs;
static std::mutex g_slabs_lock;

void slab_state_drop(void* ap) {
  std::lock_guard<std::mutex> g(g_slabs_lock);
  auto it = g_slabs.find(ap);
  if (it != g_slabs.end()) {
    delete it->second;
    g_slabs.erase(it);
  }
}

static SlabState* slab_state_for(void* ap) {
  std::lock_guard<std::mutex> g(g_slabs_lock);
  auto it = g_slabs.find(ap);
  if (it != g_slabs.end()) return it->second;
  auto* s = new SlabState();
  g_slabs.emplace(ap, s);
  return s;
}

static int slab_class_for(uint64_t size) {
  for (int c = 0; c < N_SLAB_CLASSES; c++)
    if (size <= SLAB_SIZES[c]) return c;
  return -1;
}

// allocate from the slab tier; sizes beyond the largest class defer to the
// buddy allocator (caller should use arena_alloc directly; we do it here so
// one entry point serves both, like pgstrom_shmem_alloc)
void* slab_alloc(void* ap, uint64_t size, uint64_t owner) {
  int cls = slab_class_for(size);
  if (cls < 0) return arena_alloc(ap, size, owner);
  auto* s = slab_state_for(ap);
  std::lock_guard<std::mutex> g(s->lock);
  if (!s->freelists[cls]) {
    // refill: carve one buddy chunk into objects of this class
    uint64_t obj = sizeof(SlabHeader) + SLAB_SIZES[cls] + sizeof(uint32_t);
    uint8_t* blk = (uint8_t*)arena_alloc(ap, SLAB_CHUNK - 64, 0);
    if (!blk) return nullptr;
    uint64_t count = (SLAB_CHUNK - 64) / obj;
    for (uint64_t i = 0; i < count; i++) {
      auto* h = (SlabHeader*)(blk + i * obj);
      h->magic = SLAB_MAGIC;
      h->cls = (uint8_t)cls;
      h->in_use = 0;
      h->next_free = s->freelists[cls];
      s->freelists[cls] = h;
    }
    s->n_objects[cls] += count;
  }
  SlabHeader* h = s->freelists[cls];
  s->freelists[cls] = h->next_free;
  h->in_use = 1;
  uint8_t* payload = (uint8_t*)h + sizeof(SlabHeader);
  *(uint32_t*)(payload + SLAB_SIZES[cls]) = REDZONE_MAGIC;
  s->n_alloc[cls]++;
  return payload;
}

// returns: 0 ok; 1 bad magic; 2 redzone overwritten; 3 double free;
// frees only when 0.  Objects from the buddy spillover path go through
// arena_free (their header magic distinguishes them).
int slab_free(void* ap, void* p) {
  auto* h = (SlabHeader*)((uint8_t*)p - sizeof(SlabHeader));
  {
    // buddy spillover block? (size > largest class at alloc time)
    auto* bh = (BlockHeader*)((uint8_t*)p - sizeof(BlockHeader));
    if (bh->magic == BLOCK_MAGIC) return arena_free(ap, p);
  }
  if (h->magic != SLAB_MAGIC || h->cls >= N_SLAB_CLASSES) return 1;
  auto* s = slab_state_for(ap);
  std::lock_guard<std::mutex> g(s->lock);
  if (!h->in_use) return 3;
  uint8_t* payload = (uint8_t*)p;
  if (*(uint32_t*)(payload + SLAB_SIZES[h->cls]) != REDZONE_MAGIC) return 2;
  h->in_use = 0;
  h->next_free = s->freelists[h->cls];
  s->freelists[h->cls] = h;
  s->n_free[h->cls]++;
  return 0;
}

// out: N_SLAB_CLASSES rows of (size, n_alloc, n_free, n_objects)
void slab_stats(void* ap, uint64_t* out) {
  auto* s = slab_state_for(ap);
  std::lock_guard<std::mutex> g(s->lock);
  for (int c = 0; c < N_SLAB_CLASSES; c++) {
    out[c * 4 + 0] = SLAB_SIZES[c];
    out[c * 4 + 1] = s->n_alloc[c];
    out[c * 4 + 2] = s->n_free[c];
    out[c * 4 + 3] = s->n_objects[c];
  }
}

// ===========================================================================
// mqueue + worker pool
// ===========================================================================

struct MQueue {
  std::deque<int64_t> q;
  std::mutex m;
  std::condition_variable cv;
  bool closed = false;
};

void* mq_create() { return new MQueue(); }
void mq_destroy(void* qp) { delete (MQueue*)qp; }

int mq_push(void* qp, int64_t v) {
  auto* q = (MQueue*)qp;
  {
    std::lock_guard<std::mutex> g(q->m);
    if (q->closed) return -1;
    q->q.push_back(v);
  }
  q->cv.notify_one();
  return 0;
}

// timeout_ms < 0: block forever.  returns 0 ok, 1 timeout, 2 closed+empty
int mq_pop(void* qp, int64_t* out, int64_t timeout_ms) {
  auto* q = (MQueue*)qp;
  std::unique_lock<std::mutex> g(q->m);
  auto ready = [&] { return !q->q.empty() || q->closed; };
  if (timeout_ms < 0) {
    q->cv.wait(g, ready);
  } else if (!q->cv.wait_for(g, std::chrono::milliseconds(timeout_ms), ready)) {
    return 1;
  }
  if (q->q.empty()) return 2;
  *out = q->q.front();
  q->q.pop_front();
  return 0;
}

void mq_close(void* qp) {
  auto* q = (MQueue*)qp;
  { std::lock_guard<std::mutex> g(q->m); q->closed = true; }
  q->cv.notify_all();
}

int64_t mq_depth(void* qp) {
  auto* q = (MQueue*)qp;
  std::lock_guard<std::mutex> g(q->m);
  return (int64_t)q->q.size();
}

// --- worker pool (the N-thread device-feeder, opencl_serv.c:258-292) -------

struct Pool {
  std::vector<std::thread> threads;
  std::deque<std::function<void()>> tasks;
  std::mutex m;
  std::condition_variable cv;
  std::atomic<int64_t> pending{0};
  std::condition_variable done_cv;
  bool stop = false;
};

void* pool_create(int nthreads) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  auto* p = new Pool();
  for (int i = 0; i < nthreads; i++) {
    p->threads.emplace_back([p] {
      for (;;) {
        std::function<void()> task;
        {
          std::unique_lock<std::mutex> g(p->m);
          p->cv.wait(g, [p] { return p->stop || !p->tasks.empty(); });
          if (p->stop && p->tasks.empty()) return;
          task = std::move(p->tasks.front());
          p->tasks.pop_front();
        }
        task();
        if (--p->pending == 0) p->done_cv.notify_all();
      }
    });
  }
  return p;
}

static void pool_submit(Pool* p, std::function<void()> f) {
  p->pending++;
  { std::lock_guard<std::mutex> g(p->m); p->tasks.push_back(std::move(f)); }
  p->cv.notify_one();
}

void pool_wait(void* pp) {
  auto* p = (Pool*)pp;
  std::unique_lock<std::mutex> g(p->m);
  p->done_cv.wait(g, [p] { return p->pending.load() == 0; });
}

void pool_destroy(void* pp) {
  auto* p = (Pool*)pp;
  { std::lock_guard<std::mutex> g(p->m); p->stop = true; }
  p->cv.notify_all();
  for (auto& t : p->threads) t.join();
  delete p;
}

int pool_size(void* pp) { return (int)((Pool*)pp)->threads.size(); }

// ===========================================================================
// pg_crc32 (PostgreSQL polynomial 0x04C11DB7 reflected: 0xEDB88320)
// ===========================================================================

static uint32_t crc_table[256];
static bool crc_init_done = false;
static void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t pg_crc32(const uint8_t* data, uint64_t len) {
  crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

void pg_crc32_vec_i64(const int64_t* vals, const uint8_t* valid, int64_t n,
                      uint32_t* out) {
  crc_init();
  for (int64_t i = 0; i < n; i++) {
    if (!valid[i]) { out[i] = 0; continue; }
    out[i] = pg_crc32((const uint8_t*)&vals[i], 8);
  }
}

// ===========================================================================
// pg_random: glibc TYPE_3 additive generator (what PostgreSQL <= 9.x
// random()/setseed() uses on Linux), so reference fixtures regenerate exactly
// ===========================================================================

struct PgRandom {
  int32_t r[34];
  int f, rr;
};

void* pg_random_create() { return new PgRandom(); }
void pg_random_destroy(void* s) { delete (PgRandom*)s; }

void pg_srandom(void* sp, uint32_t seed) {
  auto* s = (PgRandom*)sp;
  if (seed == 0) seed = 1;
  int32_t* r = s->r + 3;              // state words live at r[0..30]
  r[0] = (int32_t)seed;
  for (int i = 1; i < 31; i++) {
    // r[i] = (16807 * r[i-1]) % 2147483647 via Schrage to avoid overflow
    int64_t hi = r[i - 1] / 127773;
    int64_t lo = r[i - 1] % 127773;
    int64_t word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = (int32_t)word;
  }
  // glibc layout: state[0..30]; fptr=&state[3], rptr=&state[0]
  s->f = 3; s->rr = 0;
  // initstate discards 10*31 outputs
  for (int i = 0; i < 310; i++) {
    int32_t* st = s->r + 3;
    uint32_t val = (uint32_t)st[s->f] + (uint32_t)st[s->rr];
    st[s->f] = (int32_t)val;
    s->f = (s->f + 1) % 31;
    s->rr = (s->rr + 1) % 31;
  }
}

int32_t pg_random_next(void* sp) {
  auto* s = (PgRandom*)sp;
  int32_t* st = s->r + 3;
  uint32_t val = (uint32_t)st[s->f] + (uint32_t)st[s->rr];
  st[s->f] = (int32_t)val;
  s->f = (s->f + 1) % 31;
  s->rr = (s->rr + 1) % 31;
  return (int32_t)(val >> 1);
}

// PG drandom: random() / (MAX_RANDOM_VALUE + 1)
double pg_drandom(void* sp) {
  return (double)pg_random_next(sp) / 2147483648.0;
}

// ===========================================================================
// loader: parallel CSV -> columnar planes
// ===========================================================================
//
// Column type codes: 0=int64, 1=float64, 2=skip
// Output planes are caller-allocated: int64/double data + uint8 valid.

struct CsvJob {
  const char* text; int64_t len;
  const int* types; int ncols;
  int64_t row0;                  // global row index of first row in span
  void** data; uint8_t** valid;
  std::atomic<int64_t>* bad;
};

static void parse_span(const char* p, const char* end, const CsvJob& job) {
  int64_t row = job.row0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    int col = 0;
    const char* f = p;
    while (col < job.ncols) {
      const char* fe = f;
      while (fe < line_end && *fe != ',') fe++;
      int t = job.types[col];
      if (t != 2) {
        auto* valid = job.valid[col];
        if (fe == f) {
          valid[row] = 0;
        } else if (t == 0) {
          char* endp = nullptr;
          long long v = strtoll(f, &endp, 10);
          if (endp == f) { valid[row] = 0; (*job.bad)++; }
          else { ((int64_t*)job.data[col])[row] = v; valid[row] = 1; }
        } else {
          char* endp = nullptr;
          double v = strtod(f, &endp);
          if (endp == f) { valid[row] = 0; (*job.bad)++; }
          else { ((double*)job.data[col])[row] = v; valid[row] = 1; }
        }
      }
      f = fe < line_end ? fe + 1 : line_end;
      col++;
    }
    row++;
    p = line_end + 1;
  }
}

// count rows so the caller can allocate planes
int64_t csv_count_rows(const char* text, int64_t len) {
  int64_t n = 0;
  for (int64_t i = 0; i < len; i++) n += (text[i] == '\n');
  if (len > 0 && text[len - 1] != '\n') n++;
  return n;
}

// parse with the pool; data/valid are arrays of column plane pointers
int64_t csv_parse(void* pool, const char* text, int64_t len,
                  const int* types, int ncols,
                  void** data, uint8_t** valid, int nspans) {
  std::atomic<int64_t> bad{0};
  if (nspans <= 1 || !pool) {
    CsvJob job{text, len, types, ncols, 0, data, valid, &bad};
    parse_span(text, text + len, job);
    return bad.load();
  }
  // split at line boundaries; precompute row offsets per span
  std::vector<const char*> starts{text};
  std::vector<int64_t> row0s{0};
  int64_t chunk = len / nspans;
  int64_t rows_so_far = 0;
  const char* cur = text;
  for (int s = 1; s < nspans; s++) {
    const char* target = text + s * chunk;
    if (target <= cur) continue;
    const char* nl = (const char*)memchr(target, '\n', text + len - target);
    if (!nl) break;
    // count rows in [cur, nl+1)
    for (const char* q = cur; q <= nl; q++) rows_so_far += (*q == '\n');
    starts.push_back(nl + 1);
    row0s.push_back(rows_so_far);
    cur = nl + 1;
  }
  starts.push_back(text + len);
  auto* p = (Pool*)pool;
  for (size_t s = 0; s + 1 < starts.size(); s++) {
    const char* b = starts[s];
    const char* e = starts[s + 1];
    int64_t r0 = row0s[s];
    pool_submit(p, [=, &bad] {
      CsvJob job{b, e - b, types, ncols, r0, data, valid, &bad};
      parse_span(b, e, job);
    });
  }
  pool_wait(pool);
  return bad.load();
}

// ---------------------------------------------------------------------------
// extended CSV parser: int/float/date/text/numeric lanes (COPY fast path)
// type codes: 0=int64, 1=float64, 2=skip, 3=date(YYYY-MM-DD -> days since
// 2000-01-01), 4=text (fixed-width byte plane, caller-sized via
// csv_text_widths), 5=numeric (int64 mantissa + int32 dscale planes;
// >18-digit or exponent-form fields count as bad -> caller falls back)
// ---------------------------------------------------------------------------

// Howard Hinnant's days_from_civil, rebased to the PostgreSQL epoch
// 2000-01-01 (J2000): exact for the proleptic Gregorian calendar
static inline int64_t days_from_civil_2000(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468 - 10957;  // 10957 = 2000-01-01 - epoch
}

struct CsvJob2 {
  const char* text; int64_t len;
  const int* types; int ncols;
  int64_t row0;
  void** data; uint8_t** valid;
  void** aux;                    // numeric dscale planes (int32) or null
  const int64_t* widths;         // text plane strides (bytes) or null
  std::atomic<int64_t>* bad;
};

static void parse_span2(const char* p, const char* end, const CsvJob2& job) {
  int64_t row = job.row0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    int col = 0;
    const char* f = p;
    while (col < job.ncols) {
      const char* fe = f;
      while (fe < line_end && *fe != ',') fe++;
      int t = job.types[col];
      if (t != 2) {
        auto* valid = job.valid[col];
        if (fe == f) {
          valid[row] = 0;
        } else if (t == 0) {
          char* endp = nullptr;
          long long v = strtoll(f, &endp, 10);
          if (endp == f || endp != fe) { valid[row] = 0; (*job.bad)++; }
          else { ((int64_t*)job.data[col])[row] = v; valid[row] = 1; }
        } else if (t == 1) {
          char* endp = nullptr;
          double v = strtod(f, &endp);
          if (endp == f || endp != fe) { valid[row] = 0; (*job.bad)++; }
          else { ((double*)job.data[col])[row] = v; valid[row] = 1; }
        } else if (t == 3) {               // date YYYY-MM-DD
          int64_t y = 0, m = 0, d = 0;
          const char* q = f;
          bool ok = true;
          while (q < fe && *q >= '0' && *q <= '9') y = y * 10 + (*q++ - '0');
          ok = ok && q < fe && *q == '-' && q != f; q++;
          const char* q0 = q;
          while (q < fe && *q >= '0' && *q <= '9') m = m * 10 + (*q++ - '0');
          ok = ok && q < fe && *q == '-' && q != q0; q++;
          q0 = q;
          while (q < fe && *q >= '0' && *q <= '9') d = d * 10 + (*q++ - '0');
          if (ok && q == fe && q != q0 && y >= 1 && m >= 1 && m <= 12 &&
              d >= 1) {  // y == 0: PostgreSQL rejects year 0 -> python path
            static const int dim[12] = {31,28,31,30,31,30,31,31,30,31,30,31};
            int64_t md = dim[m - 1];
            if (m == 2 && (y % 4 == 0 && (y % 100 != 0 || y % 400 == 0)))
              md = 29;
            ok = d <= md;
          } else ok = false;
          if (!ok) { valid[row] = 0; (*job.bad)++; }
          else {
            ((int64_t*)job.data[col])[row] = days_from_civil_2000(y, m, d);
            valid[row] = 1;
          }
        } else if (t == 4) {               // text into fixed-width plane
          int64_t W = job.widths[col];
          int64_t L = fe - f;
          if (L > W) { valid[row] = 0; (*job.bad)++; }
          else {
            char* dst = (char*)job.data[col] + row * W;
            memcpy(dst, f, L);
            if (L < W) memset(dst + L, 0, W - L);
            valid[row] = 1;
          }
        } else {                           // t == 5: numeric
          const char* q = f;
          bool neg = false;
          if (q < fe && (*q == '+' || *q == '-')) { neg = (*q == '-'); q++; }
          long long mant = 0;
          int ndig = 0, dscale = 0, nchars = 0;
          bool seen_dot = false, ok = q < fe;
          for (; q < fe; q++) {
            if (*q == '.') {
              if (seen_dot) { ok = false; break; }
              seen_dot = true;
            } else if (*q >= '0' && *q <= '9') {
              if (ndig >= 18 && !(mant == 0 && *q == '0' && !seen_dot)) {
                ok = false; break;         // >18 significant digits
              }
              mant = mant * 10 + (*q - '0');
              if (mant != 0 || *q != '0' || seen_dot) ndig++;
              if (seen_dot) dscale++;
              nchars++;
            } else { ok = false; break; }  // exponent form etc.: fallback
          }
          // nchars == 0: a lone '.' / '-.' has no digit at all — PostgreSQL
          // rejects it, so fall back to the PG-exact python loader
          if (!ok || nchars == 0 || ndig > 18 || dscale > 32) {
            valid[row] = 0; (*job.bad)++;
          }
          else {
            ((int64_t*)job.data[col])[row] = neg ? -mant : mant;
            ((int32_t*)job.aux[col])[row] = dscale;
            valid[row] = 1;
          }
        }
      }
      f = fe < line_end ? fe + 1 : line_end;
      col++;
    }
    row++;
    p = line_end + 1;
  }
}

// max byte length per text column (one scan; sizes the fixed-width planes)
void csv_text_widths(const char* text, int64_t len, const int* types,
                     int ncols, int64_t* out_w) {
  for (int c = 0; c < ncols; c++) out_w[c] = 0;
  const char* p = text;
  const char* end = text + len;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    int col = 0;
    const char* f = p;
    while (col < ncols) {
      const char* fe = f;
      while (fe < line_end && *fe != ',') fe++;
      if (types[col] == 4 && fe - f > out_w[col]) out_w[col] = fe - f;
      f = fe < line_end ? fe + 1 : line_end;
      col++;
    }
    p = line_end + 1;
  }
}

int64_t csv_parse2(void* pool, const char* text, int64_t len,
                   const int* types, int ncols,
                   void** data, uint8_t** valid, void** aux,
                   const int64_t* widths, int nspans) {
  std::atomic<int64_t> bad{0};
  if (nspans <= 1 || !pool) {
    CsvJob2 job{text, len, types, ncols, 0, data, valid, aux, widths, &bad};
    parse_span2(text, text + len, job);
    return bad.load();
  }
  std::vector<const char*> starts{text};
  std::vector<int64_t> row0s{0};
  int64_t chunk = len / nspans;
  int64_t rows_so_far = 0;
  const char* cur = text;
  for (int sp = 1; sp < nspans; sp++) {
    const char* target = text + sp * chunk;
    if (target <= cur) continue;
    const char* nl = (const char*)memchr(target, '\n', text + len - target);
    if (!nl) break;
    for (const char* q = cur; q <= nl; q++) rows_so_far += (*q == '\n');
    starts.push_back(nl + 1);
    row0s.push_back(rows_so_far);
    cur = nl + 1;
  }
  starts.push_back(text + len);
  auto* p = (Pool*)pool;
  for (size_t sp = 0; sp + 1 < starts.size(); sp++) {
    const char* b = starts[sp];
    const char* e = starts[sp + 1];
    int64_t r0 = row0s[sp];
    pool_submit(p, [=, &bad] {
      CsvJob2 job{b, e - b, types, ncols, r0, data, valid, aux, widths, &bad};
      parse_span2(b, e, job);
    });
  }
  pool_wait(pool);
  return bad.load();
}

}  // extern "C"
