#!/bin/bash
# SLURM launcher for training the PyTorch port on NVIDIA GPU nodes: one
# task a card. Set --ntasks-per-node to the cards a node has (and --nodes);
# --gpus-per-task=1 binds each task to its card, which it then sees as
# cuda:0. Adjust partition, account and walltime to your site.
#
#   sbatch deploy/torch/slurm_train.sh configs/training/<dataset>/<exp>.yml [data_root]
#
# train_mask_bev_torch.py joins the process group from SLURM_NTASKS and
# SLURM_PROCID with MASKBEV_COORDINATOR (host:port of task 0) below
# (mask_bev_tpu_torch/parallel/distributed.py); batch_size in the config is
# the global batch, split over the tasks. The CUDA kernels are built at
# first use into mask_bev_tpu_torch/_build/ (nvcc from the CUDA toolkit).
#SBATCH --job-name=mask_bev_torch
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=8
#SBATCH --gpus-per-task=1
#SBATCH --cpus-per-task=8
#SBATCH --time=4-00:00
#SBATCH --output=logs/%x-%j.out

set -euo pipefail
CONFIG=${1:?usage: sbatch deploy/torch/slurm_train.sh configs/training/<dataset>/<exp>.yml [data_root]}
DATA_ROOT=${2:-data}

export MASKBEV_COORDINATOR=${MASKBEV_COORDINATOR:-"$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1):29500"}

srun python train_mask_bev_torch.py --config "$CONFIG" --data-root "$DATA_ROOT" --train --device cuda
