// jpegdecodeperf_c — the reference's throughput workload driven through the
// C ABI (librocjpeg_tpu_torch.so): one RocJpegHandle + `batch` stream handles PER
// THREAD, files partitioned across threads, rocJpegDecodeBatched in a loop,
// aggregated images/s + Mpixels/s. This is the reference's actual C usage
// pattern under concurrency (samples/jpegDecodePerf/jpegdecodeperf.cpp:228-258:
// a handle serializes decodes, so perf comes from many handles), which the
// in-process pytest bindings do not replicate.
//
// Usage: jpegdecodeperf_c -i <file-or-dir> [-t threads] [-b batch]
//                         [-n batches-per-thread] [-fmt native|rgb|...]
// Exits 0 on success (reference CTest pass criterion).

#include <dirent.h>
#include <sys/stat.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "../include/rocjpeg_tpu.h"

#define CHECKT(call)                                                       \
    do {                                                                   \
        RocJpegStatus s_ = (call);                                         \
        if (s_ != ROCJPEG_STATUS_SUCCESS) {                                \
            std::fprintf(stderr, "thread error: %s failed: %s\n", #call,   \
                         rocJpegGetErrorName(s_));                         \
            failures.fetch_add(1);                                         \
            return;                                                        \
        }                                                                  \
    } while (0)

namespace {

bool IsJpeg(const std::string &p) {
    FILE *f = std::fopen(p.c_str(), "rb");
    if (!f) return false;
    unsigned char magic[2] = {0, 0};
    size_t got = std::fread(magic, 1, 2, f);
    std::fclose(f);
    return got == 2 && magic[0] == 0xFF && magic[1] == 0xD8;
}

std::vector<std::string> GatherFiles(const std::string &path) {
    std::vector<std::string> out;
    struct stat st {};
    if (stat(path.c_str(), &st) != 0) return out;
    if (S_ISDIR(st.st_mode)) {
        DIR *d = opendir(path.c_str());
        if (!d) return out;
        while (dirent *e = readdir(d)) {
            std::string name = e->d_name;
            if (name == "." || name == "..") continue;
            std::string full = path + "/" + name;
            struct stat fs {};
            if (stat(full.c_str(), &fs) == 0 && S_ISREG(fs.st_mode) &&
                IsJpeg(full))
                out.push_back(full);
        }
        closedir(d);
        // Sorted, as the Python tools' file walk is, so that the split
        // across threads is the same on every file system.
        std::sort(out.begin(), out.end());
    } else if (IsJpeg(path)) {
        out.push_back(path);
    }
    return out;
}

std::vector<unsigned char> ReadFile(const std::string &p) {
    std::vector<unsigned char> data;
    FILE *f = std::fopen(p.c_str(), "rb");
    if (!f) return data;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    data.resize(static_cast<size_t>(n));
    if (std::fread(data.data(), 1, data.size(), f) != data.size())
        data.clear();
    std::fclose(f);
    return data;
}

// Tight-pitch per-channel byte sizes for one output format/subsampling —
// the caller-side sizing the reference samples do in
// GetChannelPitchAndSizes (samples/rocjpeg_samples_utils.h:318-399).
void PlaneSizes(RocJpegOutputFormat fmt, RocJpegChromaSubsampling css,
                const uint32_t w[4], const uint32_t h[4],
                uint32_t pitch[4], uint32_t rows[4]) {
    for (int i = 0; i < 4; ++i) pitch[i] = rows[i] = 0;
    switch (fmt) {
        case ROCJPEG_OUTPUT_RGB:
            pitch[0] = 3 * w[0]; rows[0] = h[0];
            break;
        case ROCJPEG_OUTPUT_RGB_PLANAR:
            for (int i = 0; i < 3; ++i) { pitch[i] = w[0]; rows[i] = h[0]; }
            break;
        case ROCJPEG_OUTPUT_Y:
            pitch[0] = w[0]; rows[0] = h[0];
            break;
        case ROCJPEG_OUTPUT_YUV_PLANAR:
            for (int i = 0; i < 3; ++i) { pitch[i] = w[i]; rows[i] = h[i]; }
            break;
        case ROCJPEG_OUTPUT_NATIVE:
        default:
            if (css == ROCJPEG_CSS_422) {
                pitch[0] = 2 * w[0]; rows[0] = h[0];
            } else if (css == ROCJPEG_CSS_420) {
                pitch[0] = w[0]; rows[0] = h[0];
                pitch[1] = 2 * w[1]; rows[1] = h[1];
            } else if (css == ROCJPEG_CSS_400) {
                pitch[0] = w[0]; rows[0] = h[0];
            } else {
                for (int i = 0; i < 3; ++i) { pitch[i] = w[i]; rows[i] = h[i]; }
            }
            break;
    }
}

std::atomic<long> total_images{0};
std::atomic<long> total_batches{0};
std::atomic<long> failures{0};
std::atomic<long> skipped{0};
std::atomic<double> total_mpix{0.0};

void AddMpix(double v) {
    double cur = total_mpix.load();
    while (!total_mpix.compare_exchange_weak(cur, cur + v)) {
    }
}

struct ThreadArgs {
    std::vector<std::string> files;
    int batch;
    int loops;
    RocJpegOutputFormat fmt;
};

void DecodeThread(const ThreadArgs &args) {
    // One handle + `batch` stream handles per thread: the reference's
    // concurrency model (a handle is a serialized session).
    RocJpegHandle handle = nullptr;
    CHECKT(rocJpegCreate(ROCJPEG_BACKEND_HARDWARE, 0, &handle));
    std::vector<RocJpegStreamHandle> streams(args.batch, nullptr);
    for (auto &s : streams) CHECKT(rocJpegStreamCreate(&s));

    std::vector<std::vector<unsigned char>> blobs;
    for (const auto &f : args.files) {
        auto d = ReadFile(f);
        if (!d.empty()) blobs.push_back(std::move(d));
    }
    if (blobs.empty()) { failures.fetch_add(1); return; }

    std::vector<RocJpegImage> images(args.batch);
    std::vector<std::vector<std::vector<uint8_t>>> bufs(args.batch);
    std::vector<RocJpegDecodeParams> params(args.batch);

    for (int loop = 0; loop < args.loops; ++loop) {
        // Fill the batch round-robin from this thread's shard; re-parse
        // every batch (the reference re-reads and re-parses per batch —
        // jpegdecodeperf.cpp:75-182).
        int n = 0;
        double mpix = 0;
        for (int b = 0; b < args.batch; ++b) {
            const auto &blob = blobs[(loop * args.batch + b) % blobs.size()];
            if (rocJpegStreamParse(blob.data(), blob.size(), streams[n]) !=
                ROCJPEG_STATUS_SUCCESS) {
                skipped.fetch_add(1);
                continue;
            }
            uint8_t nc = 0;
            RocJpegChromaSubsampling css;
            uint32_t w[4], h[4];
            CHECKT(rocJpegGetImageInfo(handle, streams[n], &nc, &css, w, h));
            if (w[0] < 64 || h[0] < 64 || css == ROCJPEG_CSS_411 ||
                css == ROCJPEG_CSS_UNKNOWN) {  // jpegdecode.cpp:120,129
                skipped.fetch_add(1);
                continue;
            }
            uint32_t pitch[4], rows[4];
            PlaneSizes(args.fmt, css, w, h, pitch, rows);
            images[n] = RocJpegImage{};
            bufs[n].assign(4, {});
            for (int c = 0; c < 4; ++c) {
                if (pitch[c] == 0) continue;
                bufs[n][c].resize(static_cast<size_t>(pitch[c]) * rows[c]);
                images[n].channel[c] = bufs[n][c].data();
                images[n].pitch[c] = pitch[c];
            }
            params[n] = RocJpegDecodeParams{};
            params[n].output_format = args.fmt;
            mpix += static_cast<double>(w[0]) * h[0] / 1e6;
            ++n;
        }
        if (n == 0) continue;
        CHECKT(rocJpegDecodeBatched(handle, streams.data(), n,
                                    params.data(), images.data()));
        total_images.fetch_add(n);
        total_batches.fetch_add(1);
        AddMpix(mpix);
    }

    for (auto &s : streams) rocJpegStreamDestroy(s);
    rocJpegDestroy(handle);
}

}  // namespace

int main(int argc, char **argv) {
    std::string input;
    int threads = 2, batch = 8, loops = 4;
    RocJpegOutputFormat fmt = ROCJPEG_OUTPUT_NATIVE;
    for (int i = 1; i < argc; ++i) {
        std::string a = argv[i];
        if (a == "-i" && i + 1 < argc) input = argv[++i];
        else if (a == "-t" && i + 1 < argc) threads = atoi(argv[++i]);
        else if (a == "-b" && i + 1 < argc) batch = atoi(argv[++i]);
        else if (a == "-n" && i + 1 < argc) loops = atoi(argv[++i]);
        else if (a == "-fmt" && i + 1 < argc) {
            std::string f = argv[++i];
            if (f == "native") fmt = ROCJPEG_OUTPUT_NATIVE;
            else if (f == "yuv_planar") fmt = ROCJPEG_OUTPUT_YUV_PLANAR;
            else if (f == "y") fmt = ROCJPEG_OUTPUT_Y;
            else if (f == "rgb") fmt = ROCJPEG_OUTPUT_RGB;
            else if (f == "rgb_planar") fmt = ROCJPEG_OUTPUT_RGB_PLANAR;
            else { std::fprintf(stderr, "unknown -fmt %s\n", f.c_str()); return 1; }
        } else {
            std::fprintf(stderr,
                         "usage: %s -i <file-or-dir> [-t N] [-b N] [-n N] "
                         "[-fmt f]\n", argv[0]);
            return 1;
        }
    }
    if (threads < 1 || threads > 32 || batch < 1) {  // samples_utils.h:153
        std::fprintf(stderr, "error: bad -t/-b\n");
        return 1;
    }
    auto files = GatherFiles(input);
    if (files.empty()) {
        std::fprintf(stderr, "error: no JPEG inputs under %s\n",
                     input.c_str());
        return 1;
    }
    std::printf("info: %zu file(s), %d thread(s) x batch %d x %d loop(s)\n",
                files.size(), threads, batch, loops);

    // Partition files across threads (jpegdecodeperf.cpp:245-252); with
    // fewer files than threads every thread takes the full list.
    std::vector<ThreadArgs> targs(threads);
    for (int t = 0; t < threads; ++t) {
        ThreadArgs &ta = targs[t];
        ta.batch = batch;
        ta.loops = loops;
        ta.fmt = fmt;
        if (files.size() >= static_cast<size_t>(threads)) {
            for (size_t i = t; i < files.size(); i += threads)
                ta.files.push_back(files[i]);
        } else {
            ta.files = files;
        }
    }

    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
        pool.emplace_back(DecodeThread, std::cref(targs[t]));
    for (auto &th : pool) th.join();
    double secs = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0).count();

    long imgs = total_images.load();
    std::printf("info: decoded %ld images in %ld batches, skipped %ld\n",
                imgs, total_batches.load(), skipped.load());
    if (secs > 0 && imgs > 0) {
        std::printf("info: %.1f images/s, %.1f Mpixels/s\n", imgs / secs,
                    total_mpix.load() / secs);
    }
    if (failures.load() != 0 || imgs == 0) {
        std::fprintf(stderr, "error: %ld thread failure(s)\n",
                     failures.load());
        return 1;
    }
    std::printf("info: success\n");
    return 0;
}
