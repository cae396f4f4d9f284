from repro_torch.serving.engine import (GenRequest, ModelServer,
                                        ServeEngine, backup_submit)

__all__ = ["ModelServer", "ServeEngine", "GenRequest", "backup_submit"]
