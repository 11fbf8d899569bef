"""Constants the port shares across modules (its own copy of the names it
needs from ``autodist_tpu/const.py``)."""

# Mesh axis names (the strategy's MeshConfig records them).
MESH_AXIS_DATA = "data"          # data parallelism (batch dim)
MESH_AXIS_REDUCE = "reduce"      # weight-update/PS sharding axis (ZeRO-style)
MESH_AXIS_MODEL = "model"        # tensor/variable partitioning axis
MESH_AXIS_SEQ = "seq"            # sequence/context parallelism axis
MESH_AXIS_EXPERT = "expert"      # expert parallelism axis
MESH_AXIS_PIPE = "pipe"          # pipeline parallelism axis
