// Native bucketed-table builder (graph/bucketed.py::build_bucketed's hot
// path): stable counting sort of the COO by destination row + padded
// per-degree-bucket table fill, one pass each — replaces ~6 numpy passes
// (argsort + fancy-index scatters) over the 2E-slot arrays that dominated
// the 10M-edge DeviceGraph build (BASELINE.md round-3 section).
//
// The output layout is BIT-IDENTICAL to the numpy builder (same cap
// schedule, ascending caps, rows in ascending node id, slots in stable
// row-major edge order) — the parity test in tests/test_native.py compares
// every table element.
//
// C ABI (ctypes), handle + copy-out protocol like loader.cpp:
//   bb_build(rows, cols, vals|NULL, eids|NULL, e, n_rows, min_cap) -> handle
//   bb_num_buckets(h), bb_total_rows(h)
//   bb_bucket_info(h, i, &cap, &nb)
//   bb_copy_bucket(h, i, idx*, val*, edge*)   // [nb, cap] row-major each
//   bb_copy_rowmaps(h, gather_pos* /*[n_rows]*/, node_of_row* /*[total+1]*/)
//   bb_close(h)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCapStep = 8;        // == bucketed.py CAP_STEP
constexpr int kCapPow2Above = 128; // == bucketed.py CAP_POW2_ABOVE

int64_t cap_for_degree(int64_t deg, int64_t min_cap) {
  int64_t d = deg < min_cap ? min_cap : deg;
  if (d <= kCapPow2Above) return ((d + kCapStep - 1) / kCapStep) * kCapStep;
  int64_t p = 1;
  while (p < d) p <<= 1;
  return p;
}

struct BucketTables {
  int64_t cap;
  int64_t nb;
  std::vector<int32_t> idx;   // [nb * cap]
  std::vector<float> val;     // [nb * cap]
  std::vector<int32_t> edge;  // [nb * cap]
};

struct Built {
  std::vector<BucketTables> buckets;
  std::vector<int32_t> gather_pos;   // [n_rows]
  std::vector<int32_t> node_of_row;  // [total_rows + 1]
  int64_t total_rows = 0;
};

}  // namespace

extern "C" {

void* bb_build(const int32_t* rows, const int32_t* cols, const float* vals,
               const int32_t* eids, int64_t e, int64_t n_rows,
               int64_t min_cap) {
  auto* out = new Built();

  // degree count
  std::vector<int64_t> deg(n_rows, 0);
  for (int64_t k = 0; k < e; ++k) ++deg[rows[k]];

  // stable counting sort by row: order[pos] = original edge index
  std::vector<int64_t> start(n_rows + 1, 0);
  for (int64_t r = 0; r < n_rows; ++r) start[r + 1] = start[r] + deg[r];
  std::vector<int64_t> cursor(start.begin(), start.end() - 1);
  std::vector<int64_t> order(e);
  for (int64_t k = 0; k < e; ++k) order[cursor[rows[k]]++] = k;

  // caps present, ascending (bounded set: 32 stepped + ~24 pow2)
  std::vector<int64_t> caps;
  {
    std::vector<char> seen(1 << 20, 0);  // caps ≤ 2^19 handled via flag array
    std::vector<int64_t> big;            // extremely large caps (hubs > 512k)
    for (int64_t r = 0; r < n_rows; ++r) {
      if (!deg[r]) continue;
      int64_t c = cap_for_degree(deg[r], min_cap);
      if (c < (1 << 20)) {
        if (!seen[c]) { seen[c] = 1; caps.push_back(c); }
      } else {
        bool dup = false;
        for (int64_t b : big) dup |= (b == c);
        if (!dup) { big.push_back(c); caps.push_back(c); }
      }
    }
    std::sort(caps.begin(), caps.end());
  }

  // bucket membership counts + row assignment in ascending node order
  std::vector<int64_t> cap_index(caps.size());
  std::vector<int64_t> nb(caps.size(), 0);
  auto cap_slot = [&](int64_t c) {
    int64_t lo = 0, hi = (int64_t)caps.size();
    while (lo < hi) { int64_t mid = (lo + hi) / 2; if (caps[mid] < c) lo = mid + 1; else hi = mid; }
    return lo;
  };
  for (int64_t r = 0; r < n_rows; ++r)
    if (deg[r]) ++nb[cap_slot(cap_for_degree(deg[r], min_cap))];

  out->buckets.resize(caps.size());
  std::vector<int64_t> row_base(caps.size(), 0);  // concat-row base per bucket
  int64_t total = 0;
  for (size_t b = 0; b < caps.size(); ++b) {
    auto& t = out->buckets[b];
    t.cap = caps[b];
    t.nb = nb[b];
    t.idx.assign((size_t)(t.nb * t.cap), 0);
    t.val.assign((size_t)(t.nb * t.cap), 0.0f);
    t.edge.assign((size_t)(t.nb * t.cap), -1);
    row_base[b] = total;
    total += t.nb;
  }
  out->total_rows = total;
  out->gather_pos.assign(n_rows, (int32_t)total);  // degree-0 → zeros row
  out->node_of_row.assign(total + 1, 0);

  // zeros-row id: numpy's collision write (node_of_row[gather_pos]=arange)
  // leaves the LAST degree-0 node id there; semantically unused, matched
  // for bit-parity with the numpy builder
  for (int64_t r = 0; r < n_rows; ++r)
    if (!deg[r]) out->node_of_row[total] = (int32_t)r;

  std::vector<int64_t> next_row(caps.size(), 0);
  for (int64_t r = 0; r < n_rows; ++r) {
    if (!deg[r]) continue;
    int64_t b = cap_slot(cap_for_degree(deg[r], min_cap));
    int64_t brow = next_row[b]++;
    out->gather_pos[r] = (int32_t)(row_base[b] + brow);
    out->node_of_row[row_base[b] + brow] = (int32_t)r;
    auto& t = out->buckets[b];
    int32_t* idx_row = t.idx.data() + brow * t.cap;
    float* val_row = t.val.data() + brow * t.cap;
    int32_t* edge_row = t.edge.data() + brow * t.cap;
    const int64_t s0 = start[r];
    for (int64_t s = 0; s < deg[r]; ++s) {
      const int64_t k = order[s0 + s];  // original edge index, stable order
      idx_row[s] = cols[k];
      if (vals) val_row[s] = vals[k];
      edge_row[s] = eids ? eids[k] : (int32_t)k;
    }
  }
  return out;
}

int64_t bb_num_buckets(void* h) { return (int64_t)static_cast<Built*>(h)->buckets.size(); }
int64_t bb_total_rows(void* h) { return static_cast<Built*>(h)->total_rows; }

void bb_bucket_info(void* h, int64_t i, int64_t* cap, int64_t* nb) {
  auto& t = static_cast<Built*>(h)->buckets[i];
  *cap = t.cap;
  *nb = t.nb;
}

void bb_copy_bucket(void* h, int64_t i, int32_t* idx, float* val, int32_t* edge) {
  auto& t = static_cast<Built*>(h)->buckets[i];
  std::memcpy(idx, t.idx.data(), t.idx.size() * sizeof(int32_t));
  std::memcpy(val, t.val.data(), t.val.size() * sizeof(float));
  std::memcpy(edge, t.edge.data(), t.edge.size() * sizeof(int32_t));
}

void bb_copy_rowmaps(void* h, int32_t* gather_pos, int32_t* node_of_row) {
  auto* built = static_cast<Built*>(h);
  std::memcpy(gather_pos, built->gather_pos.data(),
              built->gather_pos.size() * sizeof(int32_t));
  std::memcpy(node_of_row, built->node_of_row.data(),
              built->node_of_row.size() * sizeof(int32_t));
}

void bb_close(void* h) { delete static_cast<Built*>(h); }

}  // extern "C"
