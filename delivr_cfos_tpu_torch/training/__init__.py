from delivr_cfos_tpu_torch.training.losses import dice_bce_loss, dice_loss
from delivr_cfos_tpu_torch.training.train import TrainConfig, make_train_step, train

__all__ = ["dice_loss", "dice_bce_loss", "TrainConfig", "make_train_step", "train"]
