from planerecnet_tpu_torch.losses.losses import (adjoint_resize,
                                                 center_of_mass,
                                                 compute_gradient_map,
                                                 compute_losses, dice_loss,
                                                 prepare_ground_truth,
                                                 rmse_log_loss,
                                                 sigmoid_focal_loss)
from planerecnet_tpu_torch.losses.vnl import (sample_vnl_indices,
                                              vnl_loss_from_indices)
