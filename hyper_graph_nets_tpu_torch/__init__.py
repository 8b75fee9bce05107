"""PyTorch/CUDA port of hyper_graph_nets_tpu for NVIDIA Hopper (H100).

The port serves flag MeshGraphNets (flat blocks, pna aggregation) through
:class:`hyper_graph_nets_tpu_torch.serving.Predictor` and trains it through
:class:`hyper_graph_nets_tpu_torch.training.trainer.Trainer`.  With
``agg_vjp: fused`` each message-passing block runs hand-written CUDA
kernels: the forward in ``csrc/fused_block_fwd.cu`` and, in training, the
backward (``fused_bwd: remat`` or ``stream``) in ``csrc/fused_block_bwd.cu``;
with ``agg_vjp: sorted`` the pna in ``csrc/segment_pna.cu``; with the Ricci
graph balancer the curvature's (max, x) product in ``csrc/maxprod.cu``.
The package imports neither JAX nor the JAX package; ``convert.py`` takes
the JAX package's state as numpy arrays.
"""

from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.trainer import Trainer

__all__ = ["Predictor", "Trainer"]
