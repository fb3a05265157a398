"""A cell cut to a size that a CPU test holds: every width and depth kept
but the frame sizes, the batch and the search range."""

from bench_port.lib.harness import Cell

CONFIG = {"batch_size": 4, "reader_height": 64, "reader_width": 128, "img_height": 32,
          "img_width": 64, "pwc_search_range": 2}
TRAFFIC = {
    "eval": {"categories": 2, "frames_per_category": 4000, "stored_frames": 4,
             "raw_hw": [96, 160], "square": 24, "pipeline_threads": 2, "warm_batches": 1,
             "check_batches": 2},
    "train": {"pool_batches": 4, "square": 16, "max_shift": 4},
    "pretrain": {},
}
CELLS = ("cis_davis.eval_bf16", "cis_davis.eval_fp32", "cis_davis.train_fp32",
         "pwc_flow.pretrain_fp32")


def cell(name: str) -> Cell:
    c = Cell(name, overrides={"config": CONFIG})
    c.spec["traffic"].update(TRAFFIC[c.spec["entry"]])
    return c
