r"""
The preprocessing CLIs of the PyTorch port, counterparts of
``scripts/preprocess/``: annotations JSON -> vocabulary
(``build_vocabulary``), -> token H5 (``preprocess_questions``), and a folder of
images -> ResNet-101 stage-3 features H5 (``extract_features``). Each runs as
``python -m probnmn_tpu_torch.preprocess.<name>``; ``h5py`` is imported only
where a file is written, and PIL only where an image is read.
"""
