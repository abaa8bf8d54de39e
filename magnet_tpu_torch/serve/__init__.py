from magnet_tpu_torch.serve.export import (export_encode, export_fuse,
                                           export_monolithic, load_exported)

__all__ = ["export_monolithic", "export_encode", "export_fuse",
           "load_exported"]
