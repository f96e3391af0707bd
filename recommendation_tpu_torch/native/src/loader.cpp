// Native host-runtime: interaction-file loader + id indexer.
//
// Replaces the hot host-side Python work of the reference's data layer: the
// per-line split loop of `load_data` (ssl4rec.py:53-56 et al.) and the
// Python-dict id-remapping loop of `Interaction.__generate_set`
// (selfcf.py:279-290). Parses the whole file in one pass over a read buffer
// and assigns insertion-order ids with open-addressing hash maps, exactly
// matching the Python semantics (first two whitespace-separated columns,
// optional float weight defaulting to 1.0, blank/short lines skipped).
//
// C ABI (ctypes-friendly), two-call copy-out protocol:
//   rt_open(path, with_weight) -> handle (NULL on failure)
//   rt_num_edges/users/items(handle)
//   rt_copy_edges(handle, int32* users, int32* items, float* weights)
//   rt_ids_blob_size(handle, which) / rt_copy_ids_blob(handle, which, char*)
//     -> '\n'-joined external ids in id order (which: 0=users, 1=items)
//   rt_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Dataset {
  std::vector<int32_t> users;
  std::vector<int32_t> items;
  std::vector<float> weights;
  std::vector<std::string> user_ids;  // insertion order
  std::vector<std::string> item_ids;
};

bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

}  // namespace

extern "C" {

void* rt_open(const char* path, int with_weight) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size > 0 && std::fread(&buf[0], 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* ds = new Dataset();
  std::unordered_map<std::string, int32_t> umap, imap;
  umap.reserve(1 << 16);
  imap.reserve(1 << 16);

  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    // tokenize first three fields
    const char* q = p;
    const char* tok[3] = {nullptr, nullptr, nullptr};
    size_t tok_len[3] = {0, 0, 0};
    int n_tok = 0;
    while (q < line_end && n_tok < 3) {
      while (q < line_end && is_space(*q)) ++q;
      if (q >= line_end) break;
      const char* start = q;
      while (q < line_end && !is_space(*q)) ++q;
      tok[n_tok] = start;
      tok_len[n_tok] = q - start;
      ++n_tok;
    }
    if (n_tok >= 2) {
      std::string u(tok[0], tok_len[0]);
      std::string i(tok[1], tok_len[1]);
      float w = 1.0f;
      if (with_weight && n_tok >= 3) {
        // Python float() semantics: the WHOLE token must parse ("3abc" is
        // invalid and falls back to 1.0, not a 3.0 prefix like stof gives).
        std::string wtok(tok[2], tok_len[2]);
        char* endp = nullptr;
        float parsed = std::strtof(wtok.c_str(), &endp);
        if (endp == wtok.c_str() + wtok.size() && !wtok.empty()) {
          w = parsed;
        }
      }
      auto ures = umap.emplace(u, static_cast<int32_t>(ds->user_ids.size()));
      if (ures.second) ds->user_ids.push_back(u);
      auto ires = imap.emplace(i, static_cast<int32_t>(ds->item_ids.size()));
      if (ires.second) ds->item_ids.push_back(i);
      ds->users.push_back(ures.first->second);
      ds->items.push_back(ires.first->second);
      ds->weights.push_back(w);
    }
    p = line_end + 1;
  }
  return ds;
}

long rt_num_edges(void* h) { return static_cast<Dataset*>(h)->users.size(); }
long rt_num_users(void* h) { return static_cast<Dataset*>(h)->user_ids.size(); }
long rt_num_items(void* h) { return static_cast<Dataset*>(h)->item_ids.size(); }

void rt_copy_edges(void* h, int32_t* users, int32_t* items, float* weights) {
  auto* ds = static_cast<Dataset*>(h);
  memcpy(users, ds->users.data(), ds->users.size() * sizeof(int32_t));
  memcpy(items, ds->items.data(), ds->items.size() * sizeof(int32_t));
  memcpy(weights, ds->weights.data(), ds->weights.size() * sizeof(float));
}

static const std::vector<std::string>& blob_for(void* h, int which) {
  auto* ds = static_cast<Dataset*>(h);
  return which == 0 ? ds->user_ids : ds->item_ids;
}

long rt_ids_blob_size(void* h, int which) {
  const auto& ids = blob_for(h, which);
  long total = 0;
  for (const auto& s : ids) total += static_cast<long>(s.size()) + 1;
  return total;
}

void rt_copy_ids_blob(void* h, int which, char* out) {
  const auto& ids = blob_for(h, which);
  char* p = out;
  for (const auto& s : ids) {
    memcpy(p, s.data(), s.size());
    p += s.size();
    *p++ = '\n';
  }
}

void rt_close(void* h) { delete static_cast<Dataset*>(h); }

}  // extern "C"
