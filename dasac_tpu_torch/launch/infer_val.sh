#!/bin/bash
# Run inference + export on a split with the PyTorch/CUDA port:
#   SNAPSHOT_PATH=... bash dasac_tpu_torch/launch/infer_val.sh [cfg-name] [filelist]
# e.g.
#   SNAPSHOT_PATH=snapshots/.../epoch123_score0.520.pth \
#     bash dasac_tpu_torch/launch/infer_val.sh deeplabv2_resnet101_train val_cityscapes
#
# The arguments and environment of launch/infer_val.sh.  The port reads
# .pth snapshots only: convert a flax .ckpt with
#   python -m dasac_tpu.tools.export_torch --resume X.ckpt --arch A --out X.pth
# The CLI runs on every visible GPU, one process each.
set -e

CFG_NAME=${1:-deeplabv2_resnet101_train}
FILELIST=${2:-val_cityscapes}
OUTPUT_DIR=${OUTPUT_DIR:-./results}
DATALOADER=${DATALOADER:-cityscapes}
SCALES=${SCALES:-1.0}
FLIP_FLAG=${FLIP:+--flip}
# BATCH=N -> N images per step (above the GPU count = several per GPU)
BATCH_FLAG=${BATCH:+--batch $BATCH}
# SPATIAL=1 -> all GPUs per frame (bare flag); SPATIAL=N>1 -> N GPUs per
# frame, the frames spread over GPUs/N groups
SPATIAL_FLAG=""
if [ -n "${SPATIAL:-}" ]; then
  if [ "$SPATIAL" = "1" ]; then
    SPATIAL_FLAG="--spatial"
  else
    SPATIAL_FLAG="--spatial $SPATIAL"
  fi
fi

if [ -z "$SNAPSHOT_PATH" ] || [ ! -f "$SNAPSHOT_PATH" ]; then
  echo "[E] set SNAPSHOT_PATH to a .pth snapshot"
  exit 1
fi
case "$SNAPSHOT_PATH" in
  *.ckpt)
    echo "[E] SNAPSHOT_PATH=$SNAPSHOT_PATH is a flax .ckpt; the port reads .pth:"
    echo "    python -m dasac_tpu.tools.export_torch --resume $SNAPSHOT_PATH --arch <arch> --out <file>.pth"
    exit 1 ;;
esac

SAVE_ID=$(basename "$SNAPSHOT_PATH" | sed 's/\.[^.]*$//')
SAVE_DIR=$OUTPUT_DIR/$DATALOADER/$SAVE_ID/$FILELIST
LOG_FILE=$SAVE_DIR.log
mkdir -p "$SAVE_DIR"

CMD="python -m dasac_tpu_torch.infer.cli --cfg configs/${CFG_NAME}.yaml \
  --dataloader $DATALOADER --resume $SNAPSHOT_PATH \
  --infer-list data/${FILELIST}.txt --mask-output-dir $SAVE_DIR \
  --scales $SCALES $FLIP_FLAG $BATCH_FLAG $SPATIAL_FLAG"
echo "$CMD"
if [ -n "${DASAC_DRYRUN:-}" ]; then
  # test hook: print the dispatched command without launching
  exit 0
fi
$CMD 2>&1 | tee "$LOG_FILE"
