"""Label-file parsers — the reference's `label_files/` formats.

Two formats (reference: modules/lseg_module.py:97-109,
modules/lseg_module_zs.py:57-68):

- `<dataset>_objectInfo150.txt` (ADE20K): CSV with header
  'Idx,Ratio,Train,Val,Stuff,Name'; the label is the LAST comma field's
  FIRST semicolon alternative ('building;edifice' -> 'building'); the
  header row is dropped for ade20k.
- `fewshot_<dataset>.txt` (pascal/coco/fss): one stripped label per line.
"""

from __future__ import annotations

import os
from typing import List


def parse_object_info(path: str, drop_header: bool = True) -> List[str]:
    labels = []
    with open(path) as f:
        for line in f:
            label = line.strip().split(",")[-1].split(";")[0]
            labels.append(label)
    return labels[1:] if drop_header else labels


def parse_label_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


_PACKAGED = os.path.join(os.path.dirname(__file__), "..", "label_files")


def get_labels(dataset: str, label_dir: str = None) -> List[str]:
    """Label list for a dataset. With no `label_dir`, the lists vendored
    with the package are used (parsed once from the reference's
    label_files data — plain one-name-per-line). An explicit `label_dir`
    reads reference-format files from there instead."""
    if label_dir is None:
        named = ("ade20k", "citys", "pascal_voc", "pcontext")
        # pascal_aug evaluates the same 21 VOC classes
        if dataset == "pascal_aug":
            dataset = "pascal_voc"
        path = os.path.join(
            _PACKAGED,
            f"{dataset}.txt" if dataset in named
            else f"fewshot_{dataset}.txt",
        )
        if os.path.exists(path):
            return parse_label_list(path)
        raise FileNotFoundError(f"no packaged label list for {dataset!r}")
    if dataset == "ade20k":
        return parse_object_info(
            os.path.join(label_dir, "ade20k_objectInfo150.txt"),
            drop_header=True,
        )
    path = os.path.join(label_dir, f"fewshot_{dataset}.txt")
    if os.path.exists(path):
        return parse_label_list(path)
    raise FileNotFoundError(
        f"no label file for dataset {dataset!r} in {label_dir!r}"
    )
