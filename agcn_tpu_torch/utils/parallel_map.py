"""Host-side parallel processing for offline data generation
(copy of agcn_tpu/utils/parallel_map.py).

Parity target: reference utils/multiprocessing.py (parallel_processing
:16-54): chunk list arguments over a process pool with progress. Used by
the data generators to parse the ~56k-file NTU corpus.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, Iterable, List, Optional, Sequence


def parallel_map(fn: Callable, items: Sequence[Any],
                 processes: Optional[int] = None,
                 chunksize: Optional[int] = None,
                 progress: bool = False) -> List[Any]:
    """Map fn over items with a process pool; ordered results.

    Falls back to a serial map for tiny workloads or when processes=1.
    """
    n = len(items)
    processes = processes or mp.cpu_count()
    if processes <= 1 or n < 2 * processes:
        it = items
        if progress:
            try:
                from tqdm import tqdm

                it = tqdm(items)
            except ImportError:
                pass
        return [fn(x) for x in it]
    chunksize = chunksize or max(1, n // (processes * 8))
    with mp.Pool(processes) as pool:
        if progress:
            try:
                from tqdm import tqdm

                return list(tqdm(pool.imap(fn, items, chunksize), total=n))
            except ImportError:
                pass
        return pool.map(fn, items, chunksize)
