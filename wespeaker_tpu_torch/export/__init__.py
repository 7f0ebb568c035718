"""Deployment export.

- onnx_proto:  dependency-free ONNX protobuf writer/reader (wire format)
- fx_to_onnx:  torch.export program -> ONNX graph (dynamic B and T)
- onnx_numpy:  numpy executor for the emitted op subset (offline parity)
- the .pt2 (torch.export) artifact lives in bin/export_model.py
"""
