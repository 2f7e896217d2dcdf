"""PyTorch indel and SNP models + weight import (the flax packs of the JAX
package, read by path)."""

from .indel import HaploidIndelModel, IndelModel
from .registry import load_model
from .snp import HaploidSNPModel, SNPModel
from .weights import (init_params, params_from_torch_state_dict,
                      params_to_npz, torch_state_dict_from_params)
