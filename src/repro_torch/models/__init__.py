from repro_torch.models.cnn import apply_cnn, cnn_loss, init_cnn

__all__ = ["apply_cnn", "cnn_loss", "init_cnn"]
