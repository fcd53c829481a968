#!/bin/bash
# Launch a training run of the PyTorch/CUDA port:
#   bash dasac_tpu_torch/launch/train.sh [gta|synthia] [resnet101|vgg16|vgg16fcn] [base]
#
# The arguments and environment of launch/train.sh: the source selects the
# task (+ the SYNTHIA 16-class eval protocol), the net selects the config,
# "base" switches to the ABN baseline; SAC runs require RESUME (an ABN
# snapshot) and pick up importance-sampling weights when present.  The
# port reads .pth snapshots only: convert a flax .ckpt with
#   python -m dasac_tpu.tools.export_torch --resume X.ckpt --arch A --out X.pth
# Several GPUs: --set TPU.MESH_DEVICES N (the CLI spawns one process each).
set -e

DS=cityscapes
EXP=${EXP:-main}
EXP_ID=${EXP_ID:-r1}
LOG_DIR=logs/${DS}/${EXP}

# SAC adaptation: point RESUME at the ABN baseline snapshot (.pth);
# optionally override IS_WEIGHTS
RESUME=${RESUME:-}
IS_WEIGHTS=${IS_WEIGHTS:-}

SRC=$1
NET=$2
BASE=$3

case "$SRC" in
  gta)     SETS="TRAIN.TASK train_game_9K" ;;
  synthia) SETS="TRAIN.TASK train_synthia_9K VAL.IGNORE_CLASS [9,14,16]" ;;
  *) echo "Source '$SRC' not supported; use [gta|synthia]"; exit 1 ;;
esac

case "$NET" in
  resnet101) CFG_BASE=deeplabv2_resnet101 ;;
  vgg16)     CFG_BASE=deeplabv2_vgg16 ;;
  vgg16fcn)  CFG_BASE=fcn_vgg16 ;;
  *) echo "Network '$NET' not supported; use [resnet101|vgg16|vgg16fcn]"; exit 1 ;;
esac

RESUME_OPT=""
if [ "$BASE" = "base" ]; then
  CFG=configs/${CFG_BASE}.yaml
  SETS="MODEL.BASELINE True $SETS"
  EXP_ID="${EXP_ID}_abn"
else
  CFG=configs/${CFG_BASE}_train.yaml
  if [ -z "$RESUME" ] || [ ! -f "$RESUME" ]; then
    echo "[E] SAC training needs an ABN baseline snapshot: set RESUME=..."
    exit 1
  fi
  case "$RESUME" in
    *.ckpt)
      echo "[E] RESUME=$RESUME is a flax .ckpt; the port reads .pth:"
      echo "    python -m dasac_tpu.tools.export_torch --resume $RESUME --arch <arch> --out <file>.pth"
      exit 1 ;;
  esac
  RESUME_OPT="--resume $RESUME"
  if [ -z "$IS_WEIGHTS" ]; then
    IS_WEIGHTS="data/cs_weights_${NET}_${SRC}.data"
  fi
  if [ -f "$IS_WEIGHTS" ]; then
    SETS="DATASET.SAMPLE_WEIGHTS $IS_WEIGHTS $SETS"
  else
    echo "[W] IS weights '$IS_WEIGHTS' not found; using uniform sampling"
  fi
fi

EXP_ID="${EXP_ID}_${SRC}_${NET}"
LOG_FILE=$LOG_DIR/${EXP_ID}.log
mkdir -p "$LOG_DIR"

CMD="python -m dasac_tpu_torch.train.cli --dataloader $DS --cfg $CFG --exp $EXP --run $EXP_ID $RESUME_OPT --set $SETS"
echo "$CMD"
if [ -n "${DASAC_DRYRUN:-}" ]; then
  # test hook: print the dispatched command without launching
  exit 0
fi
echo "Logging to: $LOG_FILE"
nohup $CMD > "$LOG_FILE" 2>&1 &
sleep 1
tail -f "$LOG_FILE"
