// Native append-only event log with hash index and coarse scan filters.
//
// The port's own copy of the reference package's C++ event log, built by
// g++ at first use into the salted build directory
// (`ops/_build.load_host`); `data/storage/nativelog.py` binds it with
// ctypes. The record format below is the reference's byte for byte, so a
// log either package writes is read by the other.
//
// Plays the role of the reference's HBase event-store backend
// (reference: data/src/main/scala/io/prediction/data/storage/hbase/ —
// rowkey = md5(entity) ++ millis ++ uuid, HBEventsUtil.scala:81-129, and
// time-ranged scans, :286-410) as the high-throughput durable store behind
// the Python Events interface: C++ owns file IO, the id index, and coarse
// predicate filtering (time range, entity hash, event-name hash); Python
// deserializes only the surviving records.
//
// File format: sequence of records
//   u8  type        (1 = event, 2 = tombstone)
//   u16 keylen
//   u32 datalen
//   i64 ts_millis   (event time)
//   u64 entity_hash (FNV-1a of "entityType\x00entityId")
//   u64 name_hash   (FNV-1a of event name)
//   u64 target_hash (FNV-1a of "targetType\x00targetId", 0 when absent)
//   key bytes, data bytes
//
// Concurrency: one mutex per handle; scan state is per-handle (the Python
// wrapper serializes scans per handle).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <unistd.h>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct RecordHeader {
  uint8_t type;
  uint16_t keylen;
  uint32_t datalen;
  int64_t ts;
  uint64_t entity_hash;
  uint64_t name_hash;
  uint64_t target_hash;
} __attribute__((packed));

struct IndexEntry {
  uint64_t offset;   // offset of the record header
  uint32_t datalen;
  int64_t ts;
  uint64_t entity_hash;
  uint64_t name_hash;
  uint64_t target_hash;
  bool deleted;
};

struct Handle {
  FILE* f = nullptr;
  std::mutex mu;
  std::unordered_map<std::string, IndexEntry> index;
  std::vector<std::string> order;  // insertion order of live keys
  // scan state
  std::vector<const std::string*> scan_keys;
  std::vector<uint8_t> fetch_buf;
  // bulk-fetch state (el_scan_fetch)
  std::vector<uint8_t> bulk_data;
  std::vector<uint64_t> bulk_offsets;
  // columnar state (el_scan_columnar)
  std::vector<int64_t> col_ts;
  std::string col_entity, col_target, col_event, col_etype, col_ttype;
  std::vector<uint64_t> col_entity_off, col_target_off, col_event_off,
      col_etype_off, col_ttype_off;
  std::vector<double> col_prop;
  std::vector<uint8_t> col_fallback;  // 1 = record needs python json parse
  // planning state (el_scan_ts): event times only, no payload IO
  std::vector<int64_t> plan_ts;
};

uint64_t fnv1a(const uint8_t* data, size_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < len; i++) {
    h ^= data[i];
    h *= 1099511628211ULL;
  }
  return h;
}

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

// Sequential bulk reader: scan results come (almost always) in increasing
// file order, so instead of one fseeko+fread syscall pair per record the
// bulk paths stream the file through a large window and serve records by
// memcpy. Out-of-order offsets (a key overwritten by a later append keeps
// its old position in the scan order) fall back to a direct seek+read.
class SeqReader {
 public:
  SeqReader(FILE* f, size_t window = 8u << 20) : f_(f), window_(window) {}

  // copy [off, off+len) into out; returns false on IO error
  bool read(uint64_t off, uint8_t* out, size_t len) {
    if (off >= base_ && off + len <= base_ + buf_.size()) {
      memcpy(out, buf_.data() + (off - base_), len);
      return true;
    }
    if (off >= base_ + buf_.size() || buf_.empty()) {
      // advance the window to start at off
      size_t want = len > window_ ? len : window_;
      buf_.resize(want);
      if (fseeko(f_, (off_t)off, SEEK_SET) != 0) return false;
      size_t got = fread(buf_.data(), 1, want, f_);
      buf_.resize(got);
      base_ = off;
      if (got < len) return false;
      memcpy(out, buf_.data(), len);
      return true;
    }
    // behind the window: direct read, window untouched
    if (fseeko(f_, (off_t)off, SEEK_SET) != 0) return false;
    return fread(out, 1, len, f_) == len;
  }

 private:
  FILE* f_;
  size_t window_;
  uint64_t base_ = 0;
  std::vector<uint8_t> buf_;
};

}  // namespace

extern "C" {

uint64_t el_hash(const uint8_t* data, int32_t len) {
  return fnv1a(data, (size_t)len);
}

// Bulk hashing for the columnar write path: n strings packed into one
// contiguous buffer with n+1 offsets, hashed in one FFI crossing
// (3 per-record el_hash round trips was a measured ~30% of the Python
// bulk-ingest loop). A zero-length extent hashes to 0, matching the
// "target absent" convention in the record header.
void el_hash_batch(const uint8_t* data, const int64_t* offsets,
                   int32_t n, uint64_t* out) {
  for (int32_t i = 0; i < n; i++) {
    int64_t len = offsets[i + 1] - offsets[i];
    out[i] = len > 0 ? fnv1a(data + offsets[i], (size_t)len) : 0;
  }
}

void* el_open(const char* path) {
  Handle* h = new Handle();
  h->f = fopen(path, "a+b");
  if (!h->f) {
    delete h;
    return nullptr;
  }
  // build index by scanning; a record extending past EOF is a torn tail
  // (crash mid-append) — drop it by truncating to the last clean record
  // boundary, otherwise its stale index entry would read the bytes of
  // whatever is appended next (fseeko past EOF "succeeds", so the
  // extent check against the real size is required)
  fseeko(h->f, 0, SEEK_END);
  uint64_t fsize = (uint64_t)ftello(h->f);
  fseeko(h->f, 0, SEEK_SET);
  RecordHeader rh;
  std::vector<char> key;
  uint64_t clean_end = 0;
  bool torn = false;
  while (true) {
    uint64_t off = (uint64_t)ftello(h->f);
    clean_end = off;
    if (off >= fsize) break;                    // clean EOF
    if (off + sizeof(rh) > fsize) { torn = true; break; }
    if (!read_exact(h->f, &rh, sizeof(rh))) break;  // mid-file IO error
    if (off + sizeof(rh) + rh.keylen + rh.datalen > fsize) {
      torn = true;
      break;
    }
    key.resize(rh.keylen);
    // extent-checked above: a short read here is a real IO error
    if (rh.keylen && !read_exact(h->f, key.data(), rh.keylen)) break;
    if (fseeko(h->f, rh.datalen, SEEK_CUR) != 0) break;
    std::string k(key.data(), rh.keylen);
    if (rh.type == 2) {  // tombstone
      auto it = h->index.find(k);
      if (it != h->index.end()) it->second.deleted = true;
    } else {
      bool existed = h->index.count(k) != 0;
      h->index[k] = IndexEntry{off, rh.datalen, rh.ts, rh.entity_hash,
                               rh.name_hash, rh.target_hash, false};
      if (!existed) h->order.push_back(k);
    }
  }
  if (clean_end < fsize) {
    if (!torn) {
      // mid-file read error (flaky disk/NFS), NOT a torn tail: the
      // bytes past clean_end may be perfectly valid records —
      // truncating would destroy them, and appending would corrupt
      // the index. Fail closed; a retry on a healthy mount recovers.
      fclose(h->f);
      delete h;
      return nullptr;
    }
    fflush(h->f);
    if (ftruncate(fileno(h->f), (off_t)clean_end) != 0) {
      // cannot repair the tear (read-only fs?): appends would
      // interleave with the torn bytes, so fail closed
      fclose(h->f);
      delete h;
      return nullptr;
    }
  }
  fseeko(h->f, 0, SEEK_END);
  return h;
}

void el_close(void* vh) {
  Handle* h = (Handle*)vh;
  if (!h) return;
  if (h->f) fclose(h->f);
  delete h;
}

int el_append(void* vh, const uint8_t* key, int32_t keylen,
              const uint8_t* data, int32_t datalen, int64_t ts,
              uint64_t entity_hash, uint64_t name_hash,
              uint64_t target_hash) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  RecordHeader rh{1, (uint16_t)keylen, (uint32_t)datalen, ts, entity_hash,
                  name_hash, target_hash};
  fseeko(h->f, 0, SEEK_END);
  uint64_t off = (uint64_t)ftello(h->f);
  if (fwrite(&rh, 1, sizeof(rh), h->f) != sizeof(rh)) return -1;
  if (keylen && fwrite(key, 1, keylen, h->f) != (size_t)keylen) return -1;
  if (datalen && fwrite(data, 1, datalen, h->f) != (size_t)datalen)
    return -1;
  std::string k((const char*)key, keylen);
  bool existed = h->index.count(k) != 0;
  h->index[k] = IndexEntry{off, (uint32_t)datalen, ts, entity_hash,
                           name_hash, target_hash, false};
  if (!existed) h->order.push_back(k);
  return 0;
}

// Group-commit append: n records under ONE mutex acquisition and one
// contiguous buffered write. keys/datas are concatenated byte runs with
// per-record extents in keylens/datalens; ts/hash arrays are per-record.
// The whole group is serialized into one buffer and written with a
// single fwrite, so the committer pays one seek + one stdio call per
// GROUP instead of per record. On a short write the file is truncated
// back to the group's start offset (no torn garbage, no index update);
// if even the truncate fails, the torn tail is repaired by the next
// el_open. Returns n on success, -1 on failure.
int64_t el_append_batch(void* vh, int32_t n, const uint8_t* keys,
                        const int32_t* keylens, const uint8_t* datas,
                        const int64_t* datalens, const int64_t* ts,
                        const uint64_t* entity_hashes,
                        const uint64_t* name_hashes,
                        const uint64_t* target_hashes) {
  Handle* h = (Handle*)vh;
  if (n <= 0) return 0;
  std::lock_guard<std::mutex> lock(h->mu);
  fseeko(h->f, 0, SEEK_END);
  uint64_t start = (uint64_t)ftello(h->f);
  // serialize the whole group first: record offsets are known up front
  // and the index only mutates after the bytes are safely written
  uint64_t total = (uint64_t)n * sizeof(RecordHeader);
  for (int32_t i = 0; i < n; i++)
    total += (uint64_t)keylens[i] + (uint64_t)datalens[i];
  std::vector<uint8_t> buf;
  buf.reserve(total);
  std::vector<uint64_t> rec_off(n);
  uint64_t koff = 0, doff = 0;
  for (int32_t i = 0; i < n; i++) {
    rec_off[i] = start + buf.size();
    RecordHeader rh{1, (uint16_t)keylens[i], (uint32_t)datalens[i], ts[i],
                    entity_hashes[i], name_hashes[i], target_hashes[i]};
    const uint8_t* p = (const uint8_t*)&rh;
    buf.insert(buf.end(), p, p + sizeof(rh));
    buf.insert(buf.end(), keys + koff, keys + koff + keylens[i]);
    buf.insert(buf.end(), datas + doff, datas + doff + datalens[i]);
    koff += (uint64_t)keylens[i];
    doff += (uint64_t)datalens[i];
  }
  if (fwrite(buf.data(), 1, buf.size(), h->f) != buf.size()) {
    fflush(h->f);
    if (ftruncate(fileno(h->f), (off_t)start) == 0) fseeko(h->f, 0, SEEK_END);
    return -1;
  }
  koff = 0;
  h->index.reserve(h->index.size() + (size_t)n);
  for (int32_t i = 0; i < n; i++) {
    std::string k((const char*)(keys + koff), (size_t)keylens[i]);
    koff += (uint64_t)keylens[i];
    IndexEntry e{rec_off[i], (uint32_t)datalens[i], ts[i],
                 entity_hashes[i], name_hashes[i], target_hashes[i], false};
    auto ins = h->index.emplace(std::move(k), e);
    if (ins.second)
      h->order.push_back(ins.first->first);
    else
      ins.first->second = e;
  }
  return n;
}

// O(1) liveness probe on the in-memory id index — no IO. Returns 1 when
// the key names a live record, 0 otherwise.
int el_exists(void* vh, const uint8_t* key, int32_t keylen) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  auto it = h->index.find(std::string((const char*)key, keylen));
  return (it != h->index.end() && !it->second.deleted) ? 1 : 0;
}

int el_flush(void* vh) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  return fflush(h->f);
}

// Durability point for the async-fsync cadence: flush stdio buffers and
// fsync the fd. Kept separate from el_flush so the group-commit ack path
// (flush-to-OS) never pays the disk round trip.
int el_sync(void* vh) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  if (fflush(h->f) != 0) return -1;
  return fsync(fileno(h->f));
}

// The async-fsync loop's entry: flush stdio under the mutex, then hand
// back a dup'd fd so the caller can fsync OUTSIDE every lock. Holding
// the handle mutex (or the Python append lock above it) across an fsync
// convoys the group committers behind the disk — measured ~2x bulk
// ingest. The dup keeps the file description alive even if the handle
// closes mid-sync. Returns -1 on flush/dup failure.
int el_flush_dup(void* vh) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  if (fflush(h->f) != 0) return -1;
  return dup(fileno(h->f));
}

// returns datalen and fills fetch_buf, or -1 when missing/deleted
int64_t el_get(void* vh, const uint8_t* key, int32_t keylen) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  auto it = h->index.find(std::string((const char*)key, keylen));
  if (it == h->index.end() || it->second.deleted) return -1;
  const IndexEntry& e = it->second;
  h->fetch_buf.resize(e.datalen);
  fseeko(h->f, (off_t)(e.offset + sizeof(RecordHeader) + keylen), SEEK_SET);
  if (!read_exact(h->f, h->fetch_buf.data(), e.datalen)) return -1;
  fseeko(h->f, 0, SEEK_END);
  return (int64_t)e.datalen;
}

const uint8_t* el_buf(void* vh) {
  Handle* h = (Handle*)vh;
  return h->fetch_buf.data();
}

int el_delete(void* vh, const uint8_t* key, int32_t keylen) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  auto it = h->index.find(std::string((const char*)key, keylen));
  if (it == h->index.end() || it->second.deleted) return -1;
  it->second.deleted = true;
  RecordHeader rh{2, (uint16_t)keylen, 0, 0, 0, 0, 0};
  fseeko(h->f, 0, SEEK_END);
  fwrite(&rh, 1, sizeof(rh), h->f);
  fwrite(key, 1, keylen, h->f);
  return 0;
}

// Coarse scan: collect keys of live records passing the pushed-down
// predicates. 0-valued hash filters mean "no filter"; name_hashes is an
// optional array (OR semantics). Returns the match count; keys are fetched
// with el_scan_key.
int64_t el_scan(void* vh, int64_t start_ts, int64_t until_ts,
                uint64_t entity_hash, const uint64_t* name_hashes,
                int32_t n_names, uint64_t target_hash) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  h->scan_keys.clear();
  for (const std::string& k : h->order) {
    auto it = h->index.find(k);
    if (it == h->index.end() || it->second.deleted) continue;
    const IndexEntry& e = it->second;
    if (start_ts != INT64_MIN && e.ts < start_ts) continue;
    if (until_ts != INT64_MIN && e.ts >= until_ts) continue;
    if (entity_hash != 0 && e.entity_hash != entity_hash) continue;
    if (target_hash != 0 && e.target_hash != target_hash) continue;
    if (n_names > 0) {
      bool ok = false;
      for (int32_t i = 0; i < n_names; i++) {
        if (e.name_hash == name_hashes[i]) { ok = true; break; }
      }
      if (!ok) continue;
    }
    h->scan_keys.push_back(&it->first);
  }
  return (int64_t)h->scan_keys.size();
}

// Planning scan: the same pushed-down predicate walk as el_scan but
// collecting ONLY event times — no key list, no payload IO. The chunked
// reader runs this once per shard, merges and sorts the times host-side,
// and picks complete-millisecond window boundaries before any payload is
// read, so each extraction window is sized to the chunk target up front.
// Returns the match count; times are read via el_plan_ts.
int64_t el_scan_ts(void* vh, int64_t start_ts, int64_t until_ts,
                   uint64_t entity_hash, const uint64_t* name_hashes,
                   int32_t n_names, uint64_t target_hash) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  h->plan_ts.clear();
  for (const std::string& k : h->order) {
    auto it = h->index.find(k);
    if (it == h->index.end() || it->second.deleted) continue;
    const IndexEntry& e = it->second;
    if (start_ts != INT64_MIN && e.ts < start_ts) continue;
    if (until_ts != INT64_MIN && e.ts >= until_ts) continue;
    if (entity_hash != 0 && e.entity_hash != entity_hash) continue;
    if (target_hash != 0 && e.target_hash != target_hash) continue;
    if (n_names > 0) {
      bool ok = false;
      for (int32_t i = 0; i < n_names; i++) {
        if (e.name_hash == name_hashes[i]) { ok = true; break; }
      }
      if (!ok) continue;
    }
    h->plan_ts.push_back(e.ts);
  }
  return (int64_t)h->plan_ts.size();
}

// Pointer to the last el_scan_ts result (valid until the next el_scan_ts
// or el_close on this handle).
const int64_t* el_plan_ts(void* vh) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  return h->plan_ts.data();
}

// Fetch the i-th scan result's key; returns key length (buffer valid until
// the next call on this handle).
int64_t el_scan_key(void* vh, int64_t i, const uint8_t** out) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  if (i < 0 || (size_t)i >= h->scan_keys.size()) return -1;
  const std::string& k = *h->scan_keys[(size_t)i];
  *out = (const uint8_t*)k.data();
  return (int64_t)k.size();
}

// Bulk-fetch every current scan result's payload with one sequential pass:
// payloads are concatenated into one buffer with count+1 offsets. One
// C call replaces count seek+read round trips through the FFI — the bulk
// training-read path (HBPEvents scan role). Returns total bytes, or -1 on
// IO error.
int64_t el_scan_fetch(void* vh) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  h->bulk_data.clear();
  h->bulk_offsets.clear();
  h->bulk_offsets.reserve(h->scan_keys.size() + 1);
  uint64_t total = 0;
  for (const std::string* k : h->scan_keys) {
    auto it = h->index.find(*k);
    if (it == h->index.end() || it->second.deleted) continue;
    total += it->second.datalen;
  }
  h->bulk_data.reserve(total);
  h->bulk_offsets.push_back(0);
  fflush(h->f);  // SeqReader reads through the same FILE*: no stale tail
  SeqReader rd(h->f);
  for (const std::string* k : h->scan_keys) {
    auto it = h->index.find(*k);
    if (it == h->index.end() || it->second.deleted) continue;
    const IndexEntry& e = it->second;
    size_t pos = h->bulk_data.size();
    h->bulk_data.resize(pos + e.datalen);
    if (!rd.read(e.offset + sizeof(RecordHeader) + k->size(),
                 h->bulk_data.data() + pos, e.datalen)) {
      fseeko(h->f, 0, SEEK_END);
      return -1;
    }
    h->bulk_offsets.push_back((uint64_t)h->bulk_data.size());
  }
  fseeko(h->f, 0, SEEK_END);
  return (int64_t)h->bulk_data.size();
}

const uint8_t* el_scan_data(void* vh) {
  return ((Handle*)vh)->bulk_data.data();
}

// count+1 offsets into el_scan_data; valid until the next bulk fetch.
const uint64_t* el_scan_offsets(void* vh) {
  return ((Handle*)vh)->bulk_offsets.data();
}

int64_t el_scan_nfetched(void* vh) {
  Handle* h = (Handle*)vh;
  return (int64_t)(h->bulk_offsets.empty() ? 0 : h->bulk_offsets.size() - 1);
}

namespace {

// Extract the string value of top-level `"key":"..."` from a JSON payload
// WE wrote (data/storage/nativelog.py serializes Event.to_dict with
// compact separators, string keys in a known shape). Returns false when
// the key is absent or the value contains escapes / isn't a plain string
// — the caller then marks the record for exact Python parsing, so this
// fast path never has to be a general JSON parser to stay correct.
bool extract_string(const char* p, size_t n, const char* key,
                    const char** out, size_t* out_len, bool* present) {
  std::string pat = std::string("\"") + key + "\":";
  const char* end = p + n;
  const char* hit =
      (const char*)memmem(p, n, pat.data(), pat.size());
  if (!hit) { *present = false; return true; }
  *present = true;
  const char* v = hit + pat.size();
  if (v >= end) return false;
  if (*v != '"') {
    if (end - v >= 4 && memcmp(v, "null", 4) == 0) {
      *present = false;
      return true;
    }
    return false;  // non-string value
  }
  v++;
  const char* q = v;
  while (q < end && *q != '"') {
    if (*q == '\\') return false;  // escapes -> python fallback
    q++;
  }
  if (q >= end) return false;
  *out = v;
  *out_len = (size_t)(q - v);
  return true;
}

// Extract numeric `"key":<number>` inside the "properties" object.
bool extract_prop_number(const char* p, size_t n, const char* key,
                         double* out, bool* present) {
  const char* props =
      (const char*)memmem(p, n, "\"properties\":{", 14);
  if (!props) { *present = false; return true; }
  std::string pat = std::string("\"") + key + "\":";
  const char* end = p + n;
  const char* hit = (const char*)memmem(
      props, (size_t)(end - props), pat.data(), pat.size());
  if (!hit) { *present = false; return true; }
  const char* v = hit + pat.size();
  if (v >= end) return false;
  if (*v == '"' || *v == '{' || *v == '[' || *v == 't' || *v == 'f') {
    return false;  // non-number -> python decides coercion semantics
  }
  if (end - v >= 4 && memcmp(v, "null", 4) == 0) {
    *present = false;
    return true;
  }
  char* num_end = nullptr;
  std::string tmp(v, std::min<size_t>(64, (size_t)(end - v)));
  double d = strtod(tmp.c_str(), &num_end);
  if (num_end == tmp.c_str()) return false;
  *out = d;
  *present = true;
  return true;
}

}  // namespace

// Columnar extraction over the current scan results, C-side: event time
// comes from the record header (no parse at all); entityId /
// targetEntityId / event come from a targeted scan of our own JSON
// serialization; `prop_name` (optional, may be null) is pulled from the
// properties object as a double (NaN when absent). Records the fast
// scanner cannot handle exactly (escaped strings, exotic value types)
// get flag=1 and are re-parsed in Python — correctness never depends on
// the fast path. Returns the record count, or -1 on IO error.
int64_t el_scan_columnar(void* vh, const char* prop_name) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  h->col_ts.clear();
  h->col_entity.clear();
  h->col_target.clear();
  h->col_event.clear();
  h->col_etype.clear();
  h->col_ttype.clear();
  h->col_entity_off.assign(1, 0);
  h->col_target_off.assign(1, 0);
  h->col_event_off.assign(1, 0);
  h->col_etype_off.assign(1, 0);
  h->col_ttype_off.assign(1, 0);
  h->col_prop.clear();
  h->col_fallback.clear();
  std::vector<uint8_t> buf;
  fflush(h->f);  // SeqReader reads through the same FILE*: no stale tail
  SeqReader rd(h->f);
  for (const std::string* k : h->scan_keys) {
    auto it = h->index.find(*k);
    if (it == h->index.end() || it->second.deleted) continue;
    const IndexEntry& e = it->second;
    buf.resize(e.datalen);
    if (!rd.read(e.offset + sizeof(RecordHeader) + k->size(), buf.data(),
                 e.datalen)) {
      fseeko(h->f, 0, SEEK_END);
      return -1;
    }
    const char* p = (const char*)buf.data();
    const char* s = nullptr;
    size_t sl = 0;
    bool present = false;
    bool ok = true;
    uint8_t fallback = 0;
    double prop = 0.0 / 0.0;  // NaN

    ok = extract_string(p, e.datalen, "entityId", &s, &sl, &present);
    if (ok && present) h->col_entity.append(s, sl);
    else if (!ok) fallback = 1;

    if (!fallback) {
      ok = extract_string(p, e.datalen, "targetEntityId", &s, &sl,
                          &present);
      if (ok && present) h->col_target.append(s, sl);
      else if (!ok) fallback = 1;
    }
    if (!fallback) {
      ok = extract_string(p, e.datalen, "event", &s, &sl, &present);
      if (ok && present) h->col_event.append(s, sl);
      else fallback = 1;  // event is mandatory
    }
    if (!fallback) {
      ok = extract_string(p, e.datalen, "entityType", &s, &sl, &present);
      if (ok && present) h->col_etype.append(s, sl);
      else fallback = 1;  // entityType is mandatory
    }
    if (!fallback) {
      ok = extract_string(p, e.datalen, "targetEntityType", &s, &sl,
                          &present);
      if (ok && present) h->col_ttype.append(s, sl);
      else if (!ok) fallback = 1;
    }
    if (!fallback && prop_name && prop_name[0]) {
      double d;
      ok = extract_prop_number(p, e.datalen, prop_name, &d, &present);
      if (!ok) fallback = 1;
      else if (present) prop = d;
    }
    if (fallback) {
      // keep offsets consistent: no bytes appended for this record
      h->col_entity.resize(h->col_entity_off.back());
      h->col_target.resize(h->col_target_off.back());
      h->col_event.resize(h->col_event_off.back());
      h->col_etype.resize(h->col_etype_off.back());
      h->col_ttype.resize(h->col_ttype_off.back());
      prop = 0.0 / 0.0;
    }
    h->col_ts.push_back(e.ts);
    h->col_entity_off.push_back((uint64_t)h->col_entity.size());
    h->col_target_off.push_back((uint64_t)h->col_target.size());
    h->col_event_off.push_back((uint64_t)h->col_event.size());
    h->col_etype_off.push_back((uint64_t)h->col_etype.size());
    h->col_ttype_off.push_back((uint64_t)h->col_ttype.size());
    h->col_prop.push_back(prop);
    h->col_fallback.push_back(fallback);
  }
  fseeko(h->f, 0, SEEK_END);
  return (int64_t)h->col_ts.size();
}

const int64_t* el_col_ts(void* vh) { return ((Handle*)vh)->col_ts.data(); }
const double* el_col_prop(void* vh) {
  return ((Handle*)vh)->col_prop.data();
}
const uint8_t* el_col_fallback(void* vh) {
  return ((Handle*)vh)->col_fallback.data();
}

namespace {
// string-column accessors by id: 0 entity, 1 target, 2 event, 3 etype,
// 4 ttype (el_scan_columnar state)
const std::string* col_buf_of(Handle* h, int32_t c) {
  switch (c) {
    case 0: return &h->col_entity;
    case 1: return &h->col_target;
    case 2: return &h->col_event;
    case 3: return &h->col_etype;
    case 4: return &h->col_ttype;
  }
  return nullptr;
}
const std::vector<uint64_t>* col_off_of(Handle* h, int32_t c) {
  switch (c) {
    case 0: return &h->col_entity_off;
    case 1: return &h->col_target_off;
    case 2: return &h->col_event_off;
    case 3: return &h->col_etype_off;
    case 4: return &h->col_ttype_off;
  }
  return nullptr;
}
}  // namespace

// Longest value (bytes) in string column c of the current columnar scan,
// and whether any byte is non-ASCII (sets *non_ascii to 1 if so).
int64_t el_col_maxlen(void* vh, int32_t c, uint8_t* non_ascii) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  const std::string* buf = col_buf_of(h, c);
  const std::vector<uint64_t>* off = col_off_of(h, c);
  if (!buf || !off) return -1;
  int64_t m = 0;
  for (size_t i = 0; i + 1 < off->size(); i++) {
    int64_t len = (int64_t)((*off)[i + 1] - (*off)[i]);
    if (len > m) m = len;
  }
  uint8_t na = 0;
  for (unsigned char ch : *buf) {
    if (ch >= 128) { na = 1; break; }
  }
  if (non_ascii) *non_ascii = na;
  return m;
}

// Fill a caller-allocated row-major [n, maxlen] byte matrix (zero-padded
// rows) with string column c — the padded layout numpy can view as a
// fixed-width bytes array with zero per-record Python work. Returns the
// row count, or -1 on bad args.
int64_t el_col_fill(void* vh, int32_t c, uint8_t* out, int64_t maxlen) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  const std::string* buf = col_buf_of(h, c);
  const std::vector<uint64_t>* off = col_off_of(h, c);
  if (!buf || !off || off->empty() || maxlen <= 0) return -1;
  size_t n = off->size() - 1;
  memset(out, 0, (size_t)maxlen * n);
  for (size_t i = 0; i < n; i++) {
    size_t len = (size_t)((*off)[i + 1] - (*off)[i]);
    if ((int64_t)len > maxlen) return -1;
    memcpy(out + (size_t)maxlen * i, buf->data() + (*off)[i], len);
  }
  return (int64_t)n;
}

int64_t el_count(void* vh) {
  Handle* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  int64_t n = 0;
  for (auto& kv : h->index)
    if (!kv.second.deleted) n++;
  return n;
}

}  // extern "C"
