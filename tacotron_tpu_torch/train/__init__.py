from tacotron_tpu_torch.train.step import TrainState, create_train_state, train_step

__all__ = ["TrainState", "create_train_state", "train_step"]
