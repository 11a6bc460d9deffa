/* rocjpeg_tpu C API — drop-in C ABI of the PyTorch/CUDA port
 * (rocjpeg_tpu_torch), identical to the JAX package's include/rocjpeg_tpu.h.
 *
 * Exposes the same nine entry points, enum values, and struct layouts as the
 * rocJPEG C API (reference: api/rocjpeg.h:204-343) so existing call sites
 * recompile against this header unchanged. Behavioral difference: decoded
 * channels are written to caller-allocated HOST buffers (the decode runs on
 * a CUDA device through the embedded Python/PyTorch runtime, and each
 * channel is copied to the host), honoring the caller's per-channel pitch.
 *
 * Link against librocjpeg_tpu_torch.so and libpython3.X (see
 * csrc/capi/rocjpeg_capi.cpp; built at first use by
 * rocjpeg_tpu_torch.runtime.build.build_capi()). The library embeds a
 * CPython interpreter on first rocJpegCreate/rocJpegStreamCreate; all
 * functions are thread-safe. ROCJPEG_TPU_TORCH_DEVICE=cpu puts every
 * session on the host (tests).
 */
#ifndef ROCJPEG_TPU_H_
#define ROCJPEG_TPU_H_

#include <stddef.h>
#include <stdint.h>

#include "rocjpeg_tpu_version.h"

#if defined(__cplusplus)
extern "C" {
#endif

#define ROCJPEGAPI
#define ROCJPEG_MAX_COMPONENT 4

/* Opaque session handles (reference rocjpeg.h:183-201). */
typedef void *RocJpegStreamHandle;
typedef void *RocJpegHandle;

/* Status codes; values match the reference (rocjpeg.h:53-67). */
typedef enum {
    ROCJPEG_STATUS_SUCCESS = 0,
    ROCJPEG_STATUS_NOT_INITIALIZED = -1,
    ROCJPEG_STATUS_INVALID_PARAMETER = -2,
    ROCJPEG_STATUS_BAD_JPEG = -3,
    ROCJPEG_STATUS_JPEG_NOT_SUPPORTED = -4,
    ROCJPEG_STATUS_OUTOF_MEMORY = -5,
    ROCJPEG_STATUS_EXECUTION_FAILED = -6,
    ROCJPEG_STATUS_ARCH_MISMATCH = -7,
    ROCJPEG_STATUS_INTERNAL_ERROR = -8,
    ROCJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED = -9,
    ROCJPEG_STATUS_HW_JPEG_DECODER_NOT_SUPPORTED = -10,
    ROCJPEG_STATUS_RUNTIME_ERROR = -11,
    ROCJPEG_STATUS_NOT_IMPLEMENTED = -12,
} RocJpegStatus;

/* Chroma subsampling reported by rocJpegGetImageInfo (rocjpeg.h:86-94). */
typedef enum {
    ROCJPEG_CSS_444 = 0,
    ROCJPEG_CSS_440 = 1,
    ROCJPEG_CSS_422 = 2,
    ROCJPEG_CSS_420 = 3,
    ROCJPEG_CSS_411 = 4,
    ROCJPEG_CSS_400 = 5,
    ROCJPEG_CSS_UNKNOWN = -1,
} RocJpegChromaSubsampling;

/* Caller-allocated output image: up to 4 channel buffers, each with its own
 * row pitch in bytes (rocjpeg.h:104-107). Which channels are written
 * depends on RocJpegOutputFormat and the image's subsampling; see
 * docs/formats.md. */
typedef struct {
    uint8_t *channel[ROCJPEG_MAX_COMPONENT];
    uint32_t pitch[ROCJPEG_MAX_COMPONENT];
} RocJpegImage;

/* Output formats (rocjpeg.h:124-141):
 *  NATIVE     — surface-native layout per subsampling: 444/440 three planes,
 *               422 packed YUYV in channel 0, 420 Y + interleaved UV (NV12),
 *               400 single Y plane.
 *  YUV_PLANAR — Y, U, V planes at their subsampled dimensions.
 *  Y          — luma only.
 *  RGB        — packed interleaved RGB in channel 0 (pitch >= 3*width).
 *  RGB_PLANAR — R, G, B planes in channels 0..2. */
typedef enum {
    ROCJPEG_OUTPUT_NATIVE = 0,
    ROCJPEG_OUTPUT_YUV_PLANAR = 1,
    ROCJPEG_OUTPUT_Y = 2,
    ROCJPEG_OUTPUT_RGB = 3,
    ROCJPEG_OUTPUT_RGB_PLANAR = 4,
    ROCJPEG_OUTPUT_FORMAT_MAX = 5,
} RocJpegOutputFormat;

/* Decode parameters (rocjpeg.h:153-166). A crop rectangle is honored iff
 * 0 < right-left <= width and 0 < bottom-top <= height; otherwise the full
 * frame is decoded (the reference's invalid-ROI fallback,
 * src/rocjpeg_decoder.cpp:123-131). target_dimension is "(future use)" in
 * the reference and is likewise accepted but ignored. */
typedef struct {
    RocJpegOutputFormat output_format;
    struct {
        int16_t left;
        int16_t top;
        int16_t right;
        int16_t bottom;
    } crop_rectangle;
    struct {
        uint32_t width;
        uint32_t height;
    } target_dimension;
} RocJpegDecodeParams;

/* Backends (rocjpeg.h:176-179). HARDWARE maps to the CUDA device path;
 * HYBRID returns ROCJPEG_STATUS_NOT_IMPLEMENTED, as in the reference
 * (src/rocjpeg_decoder.cpp:84-88). */
typedef enum {
    ROCJPEG_BACKEND_HARDWARE = 0,
    ROCJPEG_BACKEND_HYBRID = 1,
} RocJpegBackend;

/* --- The nine entry points (reference api/rocjpeg.h:204-343) --- */

/* Create an empty parsed-stream handle. */
RocJpegStatus ROCJPEGAPI rocJpegStreamCreate(RocJpegStreamHandle *jpeg_stream_handle);

/* Parse a baseline JPEG bitstream into the handle. Returns BAD_JPEG on
 * malformed input (missing SOI/DHT/DQT, truncated markers, 16-bit DQT,
 * progressive SOF, ...). */
RocJpegStatus ROCJPEGAPI rocJpegStreamParse(const unsigned char *data, size_t length,
                                            RocJpegStreamHandle jpeg_stream_handle);

/* Release a stream handle. */
RocJpegStatus ROCJPEGAPI rocJpegStreamDestroy(RocJpegStreamHandle jpeg_stream_handle);

/* Create a decode session on CUDA device `device_id`; a device that is
 * absent returns ROCJPEG_STATUS_NOT_INITIALIZED. */
RocJpegStatus ROCJPEGAPI rocJpegCreate(RocJpegBackend backend, int device_id,
                                       RocJpegHandle *handle);

/* Release a decode session. */
RocJpegStatus ROCJPEGAPI rocJpegDestroy(RocJpegHandle handle);

/* Query components / subsampling / per-channel dimensions of a parsed
 * stream. widths/heights must each hold ROCJPEG_MAX_COMPONENT entries. */
RocJpegStatus ROCJPEGAPI rocJpegGetImageInfo(RocJpegHandle handle,
                                             RocJpegStreamHandle jpeg_stream_handle,
                                             uint8_t *num_components,
                                             RocJpegChromaSubsampling *subsampling,
                                             uint32_t *widths, uint32_t *heights);

/* Decode one parsed stream into caller buffers. */
RocJpegStatus ROCJPEGAPI rocJpegDecode(RocJpegHandle handle,
                                       RocJpegStreamHandle jpeg_stream_handle,
                                       const RocJpegDecodeParams *decode_params,
                                       RocJpegImage *destination);

/* Decode a batch of parsed streams in one call; the batch is shape-grouped
 * and each group runs as one batched pass of the CUDA kernels. */
RocJpegStatus ROCJPEGAPI rocJpegDecodeBatched(RocJpegHandle handle,
                                              RocJpegStreamHandle *jpeg_stream_handles,
                                              int batch_size,
                                              const RocJpegDecodeParams *decode_params,
                                              RocJpegImage *destinations);

/* Symbolic name for a status code (static storage; never NULL). */
extern const char *ROCJPEGAPI rocJpegGetErrorName(RocJpegStatus rocjpeg_status);

/* --- Extension (not in the reference) --- */

/* Last captured error message for a decoder or stream handle (the reference
 * stores one per handle but exposes no getter). Returns a pointer valid
 * until the next call on the same handle. */
const char *rocJpegGetLastError(RocJpegHandle handle);

#if defined(__cplusplus)
} /* extern "C" */
#endif

#endif /* ROCJPEG_TPU_H_ */
