from .storage import (  # noqa: F401
    NODE_SIZE,
    DiskStore,
    Store,
    StoreConfig,
    VecStore,
    get_merkle_tree_len,
)
from .tree import CompoundMerkleTree, MerkleProof, MerkleTree, ProofLevel  # noqa: F401
from .builders import create_tree, get_base_tree_count, split_config  # noqa: F401
