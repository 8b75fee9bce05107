"""PyTorch/CUDA port of hyper_graph_nets_tpu for NVIDIA Hopper (H100).

This slice serves flag MeshGraphNets (flat blocks, pna aggregation) through
:class:`hyper_graph_nets_tpu_torch.serving.Predictor`; with ``agg_vjp:
fused`` each message-passing block runs the hand-written CUDA kernel in
``csrc/fused_block_fwd.cu``.  The package imports neither JAX nor the JAX
package; ``convert.py`` takes the JAX package's state as numpy arrays.
"""

from hyper_graph_nets_tpu_torch.serving import Predictor

__all__ = ["Predictor"]
