/* Version constants of the port's C ABI — the analog of the reference's
 * api/rocjpeg_version.h:36-38, kept in lockstep with pyproject.toml's
 * version. */

#ifndef ROCJPEG_TPU_VERSION_H_
#define ROCJPEG_TPU_VERSION_H_

#define ROCJPEG_TPU_MAJOR_VERSION 0
#define ROCJPEG_TPU_MINOR_VERSION 5
#define ROCJPEG_TPU_PATCH_VERSION 0

#define ROCJPEG_TPU_VERSION_STR "0.5.0"

#endif /* ROCJPEG_TPU_VERSION_H_ */
