"""Figure tools of the port: the counterparts of ``scripts/figures/*.py``,
run as modules from the repository's root.

* ``python -m mask_bev_tpu_torch.figures.generate_figures --config <yml>
  --ckpt-dir <dir> --data-root <tree>``: BEV figures of validation scans
  (the scan, its GT instances, the predicted masks);
* ``python -m mask_bev_tpu_torch.figures.make_video --config <yml>
  --ckpt-dir <dir>``: one rendered frame a scan of a sequence, as a video
  (cv2) or a directory of PNG frames;
* ``python -m mask_bev_tpu_torch.figures.compute_area_stats --compute-gt
  completion --root <tree>`` / ``--pred-areas <pickle>``: GT footprint
  areas of a split and the A_pred / A_complete histogram.

Predictions come from ``MaskBevPredictor.from_checkpoint`` on the card
(``--device cpu`` runs the plain PyTorch path); data from the port's
``datasets``; drawing from ``visualization/bev_viz.py`` (matplotlib,
imported where a figure is drawn).
"""
