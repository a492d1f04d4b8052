import sys
from pathlib import Path

# the checkout's root: the harness is the package ``benchmark`` there
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
