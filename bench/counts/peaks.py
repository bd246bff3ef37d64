"""Published peaks of a card by its ``torch.cuda.get_device_name()``
(``peaks.json`` beside this file); None for a card not in the table."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def of(kind: str) -> dict | None:
    return PEAKS.get(kind)
