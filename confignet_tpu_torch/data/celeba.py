"""CelebA attribute-file parsing.

The port's own copy of ``confignet_tpu/data/celeba.py``.

Reference: confignet/dataset_utils.py:119-133.  The standard
``list_attr_celeba.txt`` format: line 0 = count, line 1 = attribute names,
then ``<filename> -1/1 ...`` rows; -1 maps to 0.
"""
from __future__ import annotations

import os
from typing import Dict


def parse_celeba_attribute_file(file_path: str) -> Dict[str, Dict[str, int]]:
    with open(file_path, "r") as fp:
        lines = fp.readlines()

    attribute_names = lines[1].split()
    attribute_labels: Dict[str, Dict[str, int]] = {}
    for line in lines[2:]:
        parts = line.split()
        if not parts:
            continue
        image_name = os.path.splitext(parts[0])[0]
        values = [0 if x == "-1" else 1 for x in parts[1:]]
        attribute_labels[image_name] = dict(zip(attribute_names, values))
    return attribute_labels
