from .bert_sparse_self_attention import BertSparseSelfAttention
from .block_sparse import block_sparse_attention, layout_gather_indices
from .flash_block_sparse import (build_block_luts,
                                 flash_block_sparse_attention)
from .sparse_attention_utils import SparseAttentionUtils
from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig,
                              build_sparsity_config)
