"""Parallelism on ``torch.distributed``: the (dp, tp) plan (``mesh.py``), the
multi-process bring-up (``multihost.py``), the collectives (``comm.py``) and
the two-stage talker | codec pipeline (``pipeline.py``)."""
