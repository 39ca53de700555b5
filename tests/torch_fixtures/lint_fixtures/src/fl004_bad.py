"""flashlint fixture: FL004 — threading outside the store dispatcher."""
import threading
from concurrent.futures import ThreadPoolExecutor


def rogue_worker(fn):
    pool = ThreadPoolExecutor(max_workers=1)
    t = threading.Thread(target=fn)
    t.start()
    return pool, t
