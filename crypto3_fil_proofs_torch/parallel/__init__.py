"""The multi-device layer: a mesh of torch devices with its collectives
(sharded.py), the sharded Merkle tree, NTT and MSM built on it, and the
multi-sector sealing pipeline (pipeline.py).

Counterpart of crypto3_fil_proofs_tpu/parallel/.
"""
