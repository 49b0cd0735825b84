"""``mx.io`` — DataIter protocol and built-in iterators.

Port of ``mxnet_tpu/io`` (reference ``python/mxnet/io/io.py``; SURVEY.md
§3.2 "io / recordio / image" row, L6): ``DataIter``, ``DataBatch``,
``DataDesc``, ``NDArrayIter``, ``PrefetchingIter``, ``ResizeIter``, and
the record iterators (``ImageRecordIter`` is built over the RecordIO
reader and ``mx.image.ImageIter``).
"""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, MNISTIter, ImageRecordIter)
