// Standalone microbench of the host library's SIMD index walkers: reads a
// JPEG, parses it with rjt_parse, builds one RjtIndexJob a copy and times
// rjt_index_scan8/16/32 over 8, 16 and 32 copies (16 and 32 only where
// rjt_index_scan16_available says the host has AVX-512), without Python.
// The counterpart of the JAX package's csrc/bench_walk.cpp, linked against
// this package's own host library (runtime/build.py builds both;
// tools/profile_walk.py runs it).
//
// Build: g++ -O3 -std=c++17 bench_walk.cpp <build_dir>/librjt_host_<hash>.so
//            -Wl,-rpath,<build_dir> -o bench_walk
// Usage: bench_walk <jpeg> [reps=5] [min_symbols=768]
//
// Prints one line of key=value pairs for the header ("hdr ...") and one a
// walker: its best time over the reps, ms an image, MB/s of scan bytes, and
// the records (lanes) and symbols of the first copy, which every copy shares.
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
// Mirrors rocjpeg_entropy.cpp's RjtParsedHeader (C ABI).
struct RjtParsedHeader {
  int32_t width, height, num_components;
  int32_t comp_id[4], h_samp[4], v_samp[4], quant_sel[4];
  uint8_t qtab[4][64];
  uint8_t load_qtab[4];
  uint8_t dc_bits[2][16], dc_vals[2][12];
  uint8_t ac_bits[2][16], ac_vals[2][162];
  uint8_t load_huff[2];
  int32_t num_scan_components;
  int32_t scan_comp_sel[4], scan_dc[4], scan_ac[4];
  int32_t restart_interval;
  int64_t scan_offset, scan_end;  // [scan_offset, scan_end) of the input
  int32_t subsampling;            // ChromaSubsampling enum value
  int64_t num_mcus;
};
int rjt_parse(const uint8_t* buf, long n, RjtParsedHeader* out);

// Mirrors rocjpeg_entropy.cpp's RjtIndexJob (C ABI).
struct RjtIndexJob {
  const uint8_t* scan;
  long scan_len;
  int num_components;
  int interleaved;
  int total_mcus;
  int min_symbols;
  int h_samp[3];
  int v_samp[3];
  int dc_table[3];
  int ac_table[3];
  const uint8_t* dc_bits[4];
  const uint8_t* dc_values[4];
  const uint8_t* ac_bits[4];
  const uint8_t* ac_values[4];
  uint8_t* clean;
  int64_t* bit_off;
  int32_t* dc_out;
  int32_t* mcu_idx;
  int32_t* sym_count;
  long n_records;
  long n_found;
};
long rjt_index_scan8(RjtIndexJob** jobs, long n, long* clean_lens);
long rjt_index_scan16(RjtIndexJob** jobs, long n, long* clean_lens);
long rjt_index_scan32(RjtIndexJob** jobs, long n, long* clean_lens);
long rjt_index_scan16_available(void);
}

namespace {

struct JobSet {
  std::vector<RjtIndexJob> jobs;
  std::vector<RjtIndexJob*> ptrs;
  std::vector<std::vector<uint8_t>> cleans;
  std::vector<std::vector<int64_t>> bit_offs;
  std::vector<std::vector<int32_t>> dcs, mis, scs;
};

// The MCUs the walk steps over: blocks for a single-component scan (as
// runtime/native.py _index_totals counts them).
long walk_units(const RjtParsedHeader& h) {
  if (h.num_scan_components > 1) return (long)h.num_mcus;
  return (long)((h.width + 7) / 8) * ((h.height + 7) / 8);
}

void build(JobSet& js, const RjtParsedHeader& h,
           const std::vector<uint8_t>& buf, int n, int min_symbols) {
  const long scan_len = h.scan_end - h.scan_offset;
  // Record capacity as runtime/native.py index_job_capacities sizes it.
  const long n_rec =
      std::min(walk_units(h), scan_len * 8 / std::max(1, min_symbols)) + 2;
  js.jobs.assign(n, RjtIndexJob{});
  js.cleans.assign(n, std::vector<uint8_t>(scan_len + 8, 0));
  js.bit_offs.assign(n, std::vector<int64_t>(n_rec));
  js.dcs.assign(n, std::vector<int32_t>(n_rec * 3));
  js.mis.assign(n, std::vector<int32_t>(n_rec));
  js.scs.assign(n, std::vector<int32_t>(n_rec));
  js.ptrs.clear();
  for (int i = 0; i < n; ++i) {
    RjtIndexJob& j = js.jobs[i];
    j.scan = buf.data() + h.scan_offset;
    j.scan_len = scan_len;
    j.num_components = h.num_scan_components;
    j.interleaved = h.num_scan_components > 1;
    j.total_mcus = (int)walk_units(h);
    j.min_symbols = min_symbols;
    // rjt_parse holds the scan's components in frame order.
    for (int k = 0; k < h.num_scan_components && k < 3; ++k) {
      j.h_samp[k] = h.h_samp[k];
      j.v_samp[k] = h.v_samp[k];
      j.dc_table[k] = h.scan_dc[k];
      j.ac_table[k] = h.scan_ac[k];
    }
    for (int t = 0; t < 2; ++t) {
      if (h.load_huff[t]) {
        j.dc_bits[t] = h.dc_bits[t];
        j.dc_values[t] = h.dc_vals[t];
        j.ac_bits[t] = h.ac_bits[t];
        j.ac_values[t] = h.ac_vals[t];
      }
    }
    j.clean = js.cleans[i].data();
    j.bit_off = js.bit_offs[i].data();
    j.dc_out = js.dcs[i].data();
    j.mcu_idx = js.mis[i].data();
    j.sym_count = js.scs[i].data();
    j.n_records = n_rec;
    js.ptrs.push_back(&j);
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <jpeg> [reps] [min_symbols]\n", argv[0]);
    return 2;
  }
  const int reps = argc > 2 ? atoi(argv[2]) : 5;
  const int min_symbols = argc > 3 ? atoi(argv[3]) : 768;
  FILE* f = fopen(argv[1], "rb");
  if (!f) {
    perror("open");
    return 1;
  }
  fseek(f, 0, SEEK_END);
  const long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  const bool read_all = fread(buf.data(), 1, sz, f) == (size_t)sz;
  fclose(f);
  if (!read_all) {
    fprintf(stderr, "short read of %s\n", argv[1]);
    return 1;
  }
  RjtParsedHeader hdr;
  const int prc = rjt_parse(buf.data(), (long)buf.size(), &hdr);
  if (prc != 0) {
    fprintf(stderr, "rjt_parse failed: %d\n", prc);
    return 1;
  }
  const long scan_len = hdr.scan_end - hdr.scan_offset;
  printf("hdr width=%d height=%d components=%d scan_components=%d "
         "restart_interval=%d scan_bytes=%ld min_symbols=%d reps=%d\n",
         hdr.width, hdr.height, hdr.num_components, hdr.num_scan_components,
         hdr.restart_interval, scan_len, min_symbols, reps);

  int failed = 0;
  auto run = [&](const char* name, int n,
                 long (*fn)(RjtIndexJob**, long, long*)) {
    JobSet js;
    std::vector<long> lens(n);
    double best = 1e30;
    for (int r = 0; r <= reps; ++r) {  // rep 0 warms up
      build(js, hdr, buf, n, min_symbols);
      auto t0 = std::chrono::steady_clock::now();
      const long rc = fn(js.ptrs.data(), n, lens.data());
      auto t1 = std::chrono::steady_clock::now();
      if (rc < 0) {
        printf("%s n=%d rc=%ld\n", name, n, rc);
        failed = 1;
        return;
      }
      if (r > 0)
        best = std::min(best,
                        std::chrono::duration<double>(t1 - t0).count());
    }
    const long recs = js.jobs[0].n_found;
    long long syms = 0;
    for (long k = 0; k < recs; ++k) syms += js.scs[0][k];
    for (int i = 1; i < n; ++i)
      if (js.jobs[i].n_found != recs) failed = 1;  // copies must agree
    printf("%s n=%d best_ms=%.4f ms_per_img=%.4f mb_s=%.1f recs_per_img=%ld "
           "syms_per_img=%lld clean_bytes=%ld\n",
           name, n, best * 1e3, best * 1e3 / n,
           (double)scan_len * n / 1e6 / best, recs, syms, lens[0]);
  };

  run("scan8", 8, rjt_index_scan8);
  if (rjt_index_scan16_available()) {
    run("scan16", 16, rjt_index_scan16);
    run("scan32", 32, rjt_index_scan32);
  }
  return failed;
}
