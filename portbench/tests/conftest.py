import os
import sys

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)
for path in (PORTBENCH, CHECKOUT):
    if path not in sys.path:
        sys.path.insert(0, path)
