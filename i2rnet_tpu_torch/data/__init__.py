"""Host data for the port: the COCO, CrowdPose and OCHuman readers with their
training and evaluation batches (``coco.py``, ``crowdpose.py``,
``ochuman.py``, ``dataset.py``; by name through ``registry.py``), image
decode and resize, records of training batches (``train_record.py``) and
synthetic raw training batches."""
