"""The node-axis mesh (parallel/sharded.py) and its declarative
placement rules (parallel/partition.py): the port of
kubernetes_tpu/parallel/."""
