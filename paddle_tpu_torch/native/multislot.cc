// Native MultiSlotDataFeed file parser (reference:
// paddle/fluid/framework/data_feed.cc MultiSlotDataFeed::ParseOneInstance
// — the CTR hot path the reference keeps in C++). Parses an entire slot
// file in one call; Python slices batches from the returned flat arrays.
//
// Line format (reference data_feed.cc): per slot, a count N followed by
// N values, repeated for every slot in declaration order.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct SlotData {
  bool is_float = false;
  std::vector<int64_t> counts;   // per row
  std::vector<int64_t> offsets;  // prefix sums of counts ([rows+1])
  std::vector<float> fvals;      // when is_float
  std::vector<int64_t> ivals;    // otherwise
};

struct MsfFile {
  int64_t rows = 0;
  std::vector<SlotData> slots;
};

}  // namespace

extern "C" {

// Returns a handle, or null on IO/parse error. is_float: one byte per
// slot (1 = float32 slot, 0 = int64 slot).
void* msf_parse_file(const char* path, int n_slots,
                     const uint8_t* is_float) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  size_t got = std::fread(&buf[0], 1, static_cast<size_t>(size), f);
  std::fclose(f);
  if (got != static_cast<size_t>(size)) return nullptr;

  auto* mf = new MsfFile();
  mf->slots.resize(static_cast<size_t>(n_slots));
  for (int j = 0; j < n_slots; ++j) mf->slots[j].is_float = is_float[j];

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  while (p < end) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    // tokens must come from THIS line only — strtoll/strtof skip
    // newlines as whitespace, which would silently consume the next
    // row's tokens on a truncated line (the Python parser and the
    // reference's MultiSlotDataFeed both treat that as a hard error)
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    std::string line(p, static_cast<size_t>(line_end - p));
    const char* lp = line.c_str();
    const char* lend = lp + line.size();
    bool row_ok = true;
    for (int j = 0; j < n_slots && row_ok; ++j) {
      char* next = nullptr;
      long long n = std::strtoll(lp, &next, 10);
      // the count must be a WHOLE integer token — "2.5" must fail, not
      // parse as count 2 with ".5" becoming the first value
      if (next == lp || n < 0 ||
          (next < lend && !std::isspace(static_cast<unsigned char>(*next)))) {
        row_ok = false;
        break;
      }
      lp = next;
      SlotData& sd = mf->slots[static_cast<size_t>(j)];
      sd.counts.push_back(n);
      for (long long t = 0; t < n; ++t) {
        if (lp >= lend) { row_ok = false; break; }
        if (sd.is_float) {
          float v = std::strtof(lp, &next);
          if (next == lp) { row_ok = false; break; }
          sd.fvals.push_back(v);
        } else {
          long long v = std::strtoll(lp, &next, 10);
          if (next == lp) { row_ok = false; break; }
          sd.ivals.push_back(v);
        }
        lp = next;
      }
    }
    if (!row_ok) { delete mf; return nullptr; }
    mf->rows += 1;
    p = line_end;
  }
  for (auto& sd : mf->slots) {
    sd.offsets.resize(sd.counts.size() + 1);
    sd.offsets[0] = 0;
    for (size_t i = 0; i < sd.counts.size(); ++i)
      sd.offsets[i + 1] = sd.offsets[i] + sd.counts[i];
  }
  return mf;
}

int64_t msf_num_rows(void* h) {
  return static_cast<MsfFile*>(h)->rows;
}

int64_t msf_slot_total(void* h, int j) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  return sd.is_float ? static_cast<int64_t>(sd.fvals.size())
                     : static_cast<int64_t>(sd.ivals.size());
}

void msf_slot_counts(void* h, int j, int64_t* out) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  std::memcpy(out, sd.counts.data(), sd.counts.size() * sizeof(int64_t));
}

void msf_slot_values_f(void* h, int j, float* out) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  std::memcpy(out, sd.fvals.data(), sd.fvals.size() * sizeof(float));
}

void msf_slot_values_i(void* h, int j, int64_t* out) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  std::memcpy(out, sd.ivals.data(), sd.ivals.size() * sizeof(int64_t));
}

// Range-based copies: Python slices one BATCH of rows at a time instead
// of materializing whole-file numpy duplicates of the parsed vectors.
int64_t msf_range_total(void* h, int j, int64_t r0, int64_t r1) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  return sd.offsets[static_cast<size_t>(r1)]
       - sd.offsets[static_cast<size_t>(r0)];
}

void msf_counts_range(void* h, int j, int64_t r0, int64_t r1,
                      int64_t* out) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  std::memcpy(out, sd.counts.data() + r0,
              static_cast<size_t>(r1 - r0) * sizeof(int64_t));
}

void msf_values_f_range(void* h, int j, int64_t r0, int64_t r1,
                        float* out) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  int64_t lo = sd.offsets[static_cast<size_t>(r0)];
  int64_t hi = sd.offsets[static_cast<size_t>(r1)];
  std::memcpy(out, sd.fvals.data() + lo,
              static_cast<size_t>(hi - lo) * sizeof(float));
}

void msf_values_i_range(void* h, int j, int64_t r0, int64_t r1,
                        int64_t* out) {
  SlotData& sd = static_cast<MsfFile*>(h)->slots[static_cast<size_t>(j)];
  int64_t lo = sd.offsets[static_cast<size_t>(r0)];
  int64_t hi = sd.offsets[static_cast<size_t>(r1)];
  std::memcpy(out, sd.ivals.data() + lo,
              static_cast<size_t>(hi - lo) * sizeof(int64_t));
}

void msf_free(void* h) { delete static_cast<MsfFile*>(h); }

}  // extern "C"
