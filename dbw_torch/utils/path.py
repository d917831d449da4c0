"""Project paths (a copy of dbw_tpu/utils/path.py)."""

from pathlib import Path

PROJECT_PATH = Path(__file__).resolve().parents[2]
CONFIGS_PATH = PROJECT_PATH / "configs"
DATASETS_PATH = PROJECT_PATH / "datasets"
RUNS_PATH = PROJECT_PATH / "runs"
