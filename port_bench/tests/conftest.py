"""Put the benchmark's folder and the system's sources on the path."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (HERE.parent / "src", HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
