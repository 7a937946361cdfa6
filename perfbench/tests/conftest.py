import sys
from pathlib import Path

# the checkout's root, so that ``perfbench`` and the port import
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
