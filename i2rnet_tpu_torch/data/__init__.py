"""Host data for the port: the COCO reader and evaluation batches (``coco.py``,
``dataset.py``), image decode and resize, and synthetic raw training batches
(the training data path is not ported yet)."""
