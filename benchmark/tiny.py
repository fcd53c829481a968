"""A cell cut to a size the CPU runs in seconds, for the benchmark's own
tests: the same configuration, traffic kind and limits, shallow
(ResNet stages of one block) and small frames, the program in float32."""

import copy


def tiny(cell):
    """``(cell, ctx keywords)`` of ``cell`` at the tests' size."""
    cell = copy.deepcopy(cell)
    t = cell.traffic
    if t["loop"] == "train":
        t["pool"] = 3
        t["source"] = {"frames": 2, "hw": [70, 100]}
        if t["stage"] == "sac":
            t["target"] = {"frames": 1, "hw": [32, 64]}
            t["cfg"].update({"DATASET.CROP_SIZE": [32, 64],
                             "TRAIN.BATCH_SIZE": 2, "TRAIN.NUM_GROUPS": 1})
        else:
            t["target"] = {"frames": 2, "hw": [64, 80]}
            t["cfg"].update({"DATASET.CROP_SIZE": [48, 48],
                             "TRAIN.BATCH_SIZE": 2, "TRAIN.NUM_GROUPS": 2})
    else:
        t.update(hw=[48, 96], pool=3, check_frames=2, warmup=1)
    kw = {"program_dtype": "float32"}
    if cell.config["cfg"]["MODEL.ARCH"] == "deeplabv2_resnet101":
        kw["model_kw"] = {"layers": (1, 1, 1, 1)}
    return cell, kw
