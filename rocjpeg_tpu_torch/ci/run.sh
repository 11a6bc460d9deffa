#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port, the counterpart of the JAX
# package's ci/run.sh. Run from anywhere in a checkout:
#
#   bash rocjpeg_tpu_torch/ci/run.sh [pytest arguments]
#
# host library and C ABI -> ASAN runner -> the port's tests -> CLI smoke on
# a synthesized corpus -> threaded C ABI perf sample; then, when torch sees
# a CUDA device, chip_smoke.py and the installed-package check on the card.
# Without a card the CLI and the C sample decode on the CPU.
set -euo pipefail
cd "$(dirname "$0")/../.."

CORPUS=$(mktemp -d)
trap 'rm -rf "$CORPUS"' EXIT
if python -c "import sys, torch; sys.exit(not torch.cuda.is_available())"; then
  CARD=1 DEVICE=0
else
  CARD=0 DEVICE=cpu
fi

echo "== host library and C ABI =="
CAPI=$(python -c "from rocjpeg_tpu_torch.runtime import build
print(build.build()); print(build.build_capi())" | tail -n 1)

echo "== ASAN (host library) =="
python -m rocjpeg_tpu_torch.tools.asan

echo "== the port's tests =="
python -m pytest tests/test_torch_*.py -q "$@"

echo "== CLI smoke (synthesized corpus: no reference images) =="
python - "$CORPUS" <<'PY'
import os, sys
from rocjpeg_tpu_torch.testing import corpus
for name, n, ri in (("restart", 4, 4), ("dri0", 2, 0)):
    os.makedirs(os.path.join(sys.argv[1], name))
    for i, blob in enumerate(corpus.build_corpus(n, 640, 480, ri_mcus=ri)):
        with open(os.path.join(sys.argv[1], name, f"{i}.jpg"), "wb") as f:
            f.write(blob)
PY
python -m rocjpeg_tpu_torch.tools.jpegdecode -i "$CORPUS" -fmt rgb -d "$DEVICE"

# The restart frames only: a batch that mixes DRI=0 and restart frames
# decodes each DRI=0 frame as one lane, which the CPU steps for minutes.
echo "== C ABI perf consumer (threaded: one handle a thread, batched) =="
SYS_PATH=$(python -c "import os, sys; print(os.pathsep.join(p for p in sys.path if p))")
if [ "$CARD" = 1 ]; then
  ROCJPEG_TPU_ROOT="$PWD" PYTHONPATH="$SYS_PATH" \
    "$CAPI/jpegdecodeperf_c" -i "$CORPUS/restart" -t 2 -b 2 -n 1 -fmt y
else
  ROCJPEG_TPU_ROOT="$PWD" PYTHONPATH="$SYS_PATH" ROCJPEG_TPU_TORCH_DEVICE=cpu \
    "$CAPI/jpegdecodeperf_c" -i "$CORPUS/restart" -t 2 -b 2 -n 1 -fmt y
fi

if [ "$CARD" = 1 ]; then
  echo "== smoke run on the card =="
  python3 chip_smoke.py
  echo "== installed-package check on the card =="
  python -m rocjpeg_tpu_torch.tools.install_check --device cuda
fi
echo "ci: OK"
