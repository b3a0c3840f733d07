"""Shared evaluation helpers (counterpart of
``confignet_tpu/apps/evaluation_utils.py``; reference:
evaluation/evaluation_utils.py).  The tkinter prompts are imported inside
their functions, for interactive use only."""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List


def dnn_filename_prompt() -> str:
    """tkinter file prompt for a model .json (interactive use only)."""
    import tkinter as tk
    from tkinter import filedialog

    root = tk.Tk()
    root.withdraw()
    file_path = filedialog.askopenfilename(filetypes=(("json files", "*.json"),))
    root.destroy()
    return file_path


def directory_prompt() -> str:
    import tkinter as tk
    from tkinter import filedialog

    root = tk.Tk()
    root.withdraw()
    dir_path = filedialog.askdirectory()
    root.destroy()
    return dir_path


def get_model_paths(model_path_or_dir: str, names_with_digits_only: bool = True) -> List[str]:
    """All model .json paths under a directory (or the path itself)."""
    if os.path.isfile(model_path_or_dir):
        return [model_path_or_dir]
    model_paths = [str(p) for p in Path(model_path_or_dir).glob("**/*.json")]
    if names_with_digits_only:
        model_paths = [p for p in model_paths if re.match(r".*[0-9]+\.json", p)]
    return model_paths
