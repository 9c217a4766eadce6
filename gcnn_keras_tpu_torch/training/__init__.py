from .losses import (masked_accuracy, masked_categorical_crossentropy, masked_graph_mae,
                     masked_graph_mse, masked_node_mae, masked_node_mse, force_loss)
from .trainer import Trainer, TrainState
